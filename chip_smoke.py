"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the kernels of ``miniworld_tpu_torch`` from
``miniworld_tpu_torch/csrc`` with nvcc (one process per source), holds
each against its plain PyTorch version on the card — at Hallway's,
PickupObjects', the 8x8 Maze's and Sidewalk's shapes (mazegen's mazes
also checked as spanning trees, tri_pass on the paired procgen bank,
place with a maze's room weights and gated walls, with budgets exhausted
and with tries over two rounds of lanes) and on wide synthetic cases;
tri_pass and pixel_epilogue must agree on every pixel, tri_pass also on
rows that graze its cull's margins, tri_pass with mesh rows (the
mesh-entity pass in its launch) with the mesh pass seeding the plain
version, at PickupObjects', on 1,000 wide and 1,024 grazing mesh rows
and on a paired maze, and the multi-chunk tri_pass with tri_pass_chunked on
Sidewalk views (chunks of 1,024, 496 and 16), WallGap views and a bank
whose prims repeat across chunk boundaries (the ties the chunk rule
decides). Domain randomisation's texture-variant override in tri_pass is
held against the plain versions' per-row override on every route
([dr-stages]: FourRooms and Hallway in one chunk, Sidewalk in 3, the 8x8
procgen Maze's paired bank at B=8192, the 8x8 Maze's layout bank as
packed PVS, PickupObjects with mesh rows; each env's camera spread; the
banks' own variant tables and synthetic ones), with winners and t equal
to the launch without the key, and the supersample=2 epilogue against
its plain version ([ss-epilogue]). It reports what tri_pass's culling
keeps ([tri-cull]) and times tri_pass rebuilt with other tiles
([tile-sweep]), then drives the port's main paths and checks what comes
out: the Hallway fused rollout
at B=1024, the PickupObjects one at B=4096, the Maze 8x8 procgen one at
B=8192 and the Sidewalk, WallGap and NavigateWallGap ones at B=1024
(80x60 RGB-D, random policy from a key), Hallway and PickupObjects
against their plain paths, a MazeS3 procgen rollout at B=1024 with
10-step episodes against its plain path (every env resets into fresh
mazes), Sidewalk, WallGap, NavigateWallGap and YMaze at B=128 against
their plain paths, short FourRooms, TMaze, MazeS3 bank-mode, OneRoom
and YMaze-family rollouts, then the Maze 8x8 procgen rollout at B=8192
and the FourRooms one at B=1024 with domain randomisation, the Hallway
one at B=1024 and the PickupObjects one at B=4096 with supersample=2,
and FourRooms and MazeS3 procgen with domain randomisation and Hallway
with supersample=2 at B=128 against their plain paths, exactly. Sign's
glyph epilogue (K=64, the GAIN instances) is held against its plain
version at SS=1 and SS=2 ([gain-epilogue]), and the paired tri_pass over
2 chunks of 496 whose second is clamped to rows 112-607 against
tri_pass_chunked on the 8x8 procgen Maze at supersample=2, with and
without the override, and on a paired tie bank ([paired-chunks]); then
the Sign rollout at B=1024 and the Maze 8x8 procgen one at B=8192 with
supersample=2, short GreenKey and ThreeRooms rollouts, and Sign (exactly),
GreenKey and ThreeRooms at B=128 against their plain paths. With
tex_mode="nearest", tri_pass (the bf16 and float32 attribute carries) and
the NEAREST epilogue are held exactly against their plain versions on
Hallway (B=128 and B=1024), PickupObjects, Sidewalk, Sign, the 8x8
procgen Maze (also at supersample=2 in 2 chunks of 496, and at B=8192,
timed) and FourRooms with domain randomisation ([nearest-stages]); then
the Maze 8x8 procgen nearest rollout at B=8192, the Hallway one at
B=1024, and Hallway nearest at B=128 against its plain path, exactly.
The continuous-action ids follow: RoomObjects' render stages at B=4096
against their plain versions, its rollout at B=4096 and a short PutNext
one on (B, 6) action vectors, both at B=128 against their plain paths.
CollectHealth at B=1024: its render stages against their plain versions
(tri_pass with the 18 kits' 864 mesh rows in its launch, on every
pixel), timed, the mesh rows' kernel and plain version beside them; the kit
respawn's place_one kernel against _place_one env for env (a step's
inputs, radii scaled until most envs exhaust the budget, budgets 0, 31
and 40, and the 8x8 procgen Maze's agent row, gated walls, equal to
place_all's agent), a pickup step through the kernels and the plain
versions (states equal, kits respawned), then its rollout against the
plain path, exactly, with breakdown and profile (and the profile again
with the mesh rows' plain version in place of their kernel, as at
PickupObjects B=4096: device events and busy ms a step without and with
it). The mesh_rows kernel is held bit for bit against
entity_mesh_rows_plain ([kernel-vs-plain] kernel=entity_mesh_rows) at
CollectHealth B=1024, PickupObjects B=4096, Sign B=1024 and PickupObjects
in nearest mode, a fifth of the entities dead, yaws over four turns, the
layout ids also as int64, each timed beside its plain version and bound.
CameraControl and
CameraControlClick at B=1024 against their plain paths, exactly, the
crosshair red on every frame and the overlay timed; tri_pass (mesh rows
included), entity_pass and the SS=1 and SS=2 epilogues held on every
pixel at CameraControl's extremes (B=256: fov 20 and 90, pitch +-89,
cameras 0.1 m from a wall, facing it).
Then the top view (view="top"): tri_pass_ortho and topview_epilogue held
exactly against their plain versions at B=128 on Hallway, PickupObjects,
FourRooms nearest, Sign, the 8x8 procgen Maze (also at 96x72, where each
env's kill decides winners) and the MazeS3 bank (64 layouts mixed among
a block's envs), tri_pass_ortho on a tie bank (equal prims in one tile:
the first wins; tile lists of more than 32 rows), each line with the
rows a pixel scans, and at the Maze's B=8192, timed there, the epilogue
beside its term issue floor ([topview-stages]); visible_ents against its plain
version on every (env, entity) at PickupObjects B=4096 and the Maze
B=8192, timed, and its own path of steps and queries, then at B=1024
boxes close to the eye, behind closed walls, astride the near plane and
at the agent's own position, and ThreeRooms, each with the visible count
it expects and the kernel's counts on a [vis-cull] line ([visible-ents]);
the Maze 8x8 procgen top-view rollout at B=8192 with its breakdown and
profile, the PickupObjects one at B=4096, and Hallway's top view at B=128
against its plain path, exactly. Last, the scheduled tri_pass (the SCHED
instances: each env scans its own list of chunks): held exactly against
tri_pass_scheduled ([sched-stages]) at B=128 on FourRooms, FourRooms with
domain randomisation, ThreeRooms (mesh rows) and the MazeS3 bank, all at
tri_chunk=16 (packed PVS over 2 chunks), on the 8x8 Maze's layout bank
at 160x120 with supersample=2 (packed PVS over 2 chunks of 96), also
with domain randomisation, with the float32 carry where neither mesh
rows nor the override run, on two tie banks (the schedule's position
rule with repeated chunks; a mesh row and a static row at equal
quantized depth), and at the Maze bank's B=1024 with envs in the rooms
whose clamped slot repeats a chunk, timed; then the Maze bank's rollout
at B=1024 with its breakdown and profile, with domain randomisation,
ThreeRooms, FourRooms and the MazeS3 bank at tri_chunk=16 at B=1024, and
at B=128 against their plain paths. The multi-chunk tri_pass (its own
windowed kernel) is also held exactly at Sidewalk's B=1024 with the
override and the float32 carry, on the paired Maze at B=1024 with the
float32 carry, and on 4,096 rows all in view over several windows (chunks
of 1,024 and 1,000; [tri-window] gives the views' image survivors against
the window); entity_pass and the SS=2 epilogue are held and timed at
the Maze supersample=2 path's B=8192 and 160x120 samples, the epilogue
beside the issue rate's floor for its Fourier terms (issue_floor_ms,
from cuobjdump -sass). entity_pass is held exactly under its contract
(t at every sample, colour and normal where t is finite), and every
epilogue instance (SS=1, SS=2, GAIN, NEAREST) gives the same pixels with
NaN at the entity's misses as with zeros there ([ent-undefined]).
mazegen is held bit for bit on 2x2, 3x3, 8x8 and 16x16 grids and timed
at one env an SM (chain_ms). Then the trainers ([train]): A2C and PPO
(horizon 16, 2 epochs of 4 minibatches) on OneRoomS6Fast at B=1024 through
``make_train_step`` / ``make_ppo_step``, two warm-up iterations and three
timed, each step's ms split into rollout and update, the metrics finite,
the parameters moved and every render kernel launched 16 times a step;
the learner's forward, forward + backward and Adam timed at the step's
16,384 frames ([train-learner]) and one A2C step profiled
([train-profile]); one A2C step of the Gaussian head and one on Sign's
dict observations at B=256; and the policy's rollout at B=128 with the
kernels against the plain path, equal in actions, rewards, dones and
checksums ([train-parity]). Then the gymnasium adapter ([gym];
gym_env.SingleEnv, the adapter without gymnasium, which the card's image
lacks): every id reset and stepped 10 times at 80x60, each frame and its
RGB-D render equal to the plain render of the same state exactly, the
top view and get_visible_ents likewise on Hallway, PickupObjects, MazeS2
and CollectHealth, every kernel its plans name launched (launches_gym on
the kernels line); the goldens of tests/golden and tests/golden_ref
replayed bit for bit ([gym-goldens]); frames a second on Hallway,
PickupObjects, the 8x8 Maze and CollectHealth ([gym-fps]). Last, the
layout-bank refresh ([refresh]): MazeS3 with 4 layouts and the 4x4 Maze
with 4 at B=1024, refreshed in their installed plans and rolled out with
the kernels and plain, exactly; and the A2C twin refreshing the MazeS3
bank every 2 iterations ([refresh-train]). Then the float32 carry above
256 ids and the dense super-bank kill ([f32-dense]): banks whose Fourier
atlas is tiled past 256 rows (vector.widen_atlas), whose layout-local
slot ids are moved above 256 (vector.raise_slot_ids) and procgen super
banks without their paired rows, each render held stage by stage against
the plain versions, exactly, after the staged winner store and the
compacted ACTIVE staging on synthetic banks ([store-case]: ties inside and
across chunks, 4,096 rows in view over several windows, mesh-seeded
winners with misses, the SCHED tie banks, in the float32 carry with and
without the override; ACTIVE in one chunk and several, bf16 and F32): the
8x8 procgen Maze at B=8192 with domain
randomisation widened (paired F32 x OVERRIDE, the Fourier F32 epilogue),
dense and dense with domain randomisation (ACTIVE, beside the paired
launch on the same states), timed; Sidewalk widened (MULTI F32 x
OVERRIDE), the Maze bank widened at 160x120 supersample=2 (SCHED x
OVERRIDE x F32, the SS=2 F32 epilogue), Sign widened (GAIN and MESH F32),
PickupObjects and ThreeRooms tri_chunk=16 nearest with raised ids (MESH
F32, SCHED x MESH F32) and the dense Maze at 160x120 supersample=2 (ACTIVE
over 2 chunks of 496) at B=1024, timed, each [store] line beside the same
launch in the bf16 carry and its bound; the other new instances at B=128
(with mesh rows and the override in F32, the Maze nearest (paired F32),
ACTIVE in F32, Sign SS=2 F32, a
K=6 table in both carries and its top view); every path's rollout, and
the three Maze paths at B=128 against their plain paths exactly. Last,
the manual-control command line headless on the card ([cli]).
One line per phase; the JSON summary of the
kernels and the card's ``nvidia-smi`` name and power limit come before
the last line,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase raises, so the script exits non-zero and prints no
result; so does a machine without CUDA, or a directory without the
package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
ENV_ID = "MiniWorld-Hallway-v0"
PICK_ID = "MiniWorld-PickupObjects-v0"
B, W, H = 1024, 80, 60  # Hallway, and the FourRooms / TMaze / parity rollouts
B_PICK = 4096  # PickupObjects, the reference's BASELINE batch for it
# The horizons are cut to keep the run near ten minutes as paths are
# added: 12 steps for the main paths, 8 for the short ones, 4 for the
# profiles of the main paths (PROFILE_STEPS), 4 for the kernel-vs-plain
# rollouts (PLAIN_HORIZON: a plain step takes up to a second)
HORIZON = 12
PROFILE_STEPS = 4
TRIALS = 2  # Hallway; PickupObjects runs PICK_TRIALS
PICK_TRIALS = 3
SHORT_HORIZON = 8  # FourRooms, TMaze, MazeS3 bank-mode and the PickupObjects parity rollouts
MAZE_ID = "MiniWorld-Maze-v0"  # 8x8, procgen: BASELINE config 4
MAZE_S3_ID = "MiniWorld-MazeS3-v0"
B_MAZE = 8192
MAZE_S3_STEPS = 6  # episode length of the MazeS3 parity rollout: every env resets
MAZE_S3_HORIZON = 2 * MAZE_S3_STEPS  # its trials: two episodes each
# the widest static banks: Sidewalk (S = 3,072 in 3 chunks of 1,024) and
# WallGap / NavigateWallGap (S = 2,048, 2 chunks), main paths at B
SIDE_ID, WALL_ID, NAV_ID = ("MiniWorld-Sidewalk-v0", "MiniWorld-WallGap-v0",
                            "MiniWorld-NavigateWallGap-v0")
B_STAGE = 64  # the multi-chunk stage checks
B_PLAIN = 128  # the multi-chunk ids' and YMaze's kernel-vs-plain rollouts
PLAIN_HORIZON = 4
# Sign: the SDF glyph branch of the epilogue at K = 64, dict observations;
# GreenKey and ThreeRooms: the other discrete-table ids of the slice
SIGN_ID, GREEN_ID, THREE_ID = ("MiniWorld-Sign-v0", "MiniWorld-GreenKey-v0",
                               "MiniWorld-ThreeRooms-v0")
FOUR_ID = "MiniWorld-FourRooms-v0"
# the ids whose plan at tri_chunk=16 is packed PVS over 2 chunks a render,
# with their other constructor arguments
SCHED_IDS = ((THREE_ID, {}), (FOUR_ID, {}), (MAZE_S3_ID, {"procgen": False}))
# the continuous-action ids (raw 6-D actions): RoomObjects at B_ROOM, its
# placement at budget 48 and agent radius 1.5, and PutNext
ROOM_ID, PUTNEXT_ID = "MiniWorld-RoomObjects-v0", "MiniWorld-PutNext-v0"
B_ROOM = 4096
# the last three ids: CollectHealth (18 medkit meshes, 864 mesh rows a
# render, the kit respawn's place_one every step) at B, and the camera ids
# (their own physics, reset and crosshair) at B, their extremes at B_EXT
HEALTH_ID, CAM_ID, CLICK_ID = ("MiniWorld-CollectHealth-v0", "MiniWorld-CameraControl-v0",
                               "MiniWorld-CameraControlClick-v0")
B_EXT = 256
SHORT_IDS = ("MiniWorld-OneRoom-v0", "MiniWorld-OneRoomS6-v0", "MiniWorld-OneRoomS6Fast-v0",
             "MiniWorld-YMaze-v0", "MiniWorld-YMazeLeft-v0", "MiniWorld-YMazeRight-v0")
# the trainers (parallel/train.py): A2C and PPO on their default env at
# B_TRAIN, TRAIN_WARMUP iterations then TRAIN_ITERS timed; the Gaussian
# head and Sign's dict observations at B_TRAIN_SIDE; the policy's rollout
# kernels vs plain at B_PLAIN
TRAIN_ID = "MiniWorld-OneRoomS6Fast-v0"
B_TRAIN, B_TRAIN_SIDE = 1024, 256
TRAIN_HORIZON, TRAIN_EPOCHS, TRAIN_MINIBATCHES = 16, 2, 4
TRAIN_WARMUP, TRAIN_ITERS = 2, 2

# the gymnasium adapter: every id reset and GYM_STEPS steps at W x H; the
# top view and the visibility query on GYM_TOP_IDS; frames a second on
# GYM_FPS_IDS over GYM_FPS_STEPS steps; the kernels its path must launch
GYM_STEPS, GYM_SEED, GYM_FPS_STEPS = 6, 5, 50
GYM_TOP_IDS = ("Hallway", "PickupObjects", "MazeS2", "CollectHealth")
GYM_FPS_IDS = ("Hallway", "PickupObjects", "Maze", "CollectHealth")
GYM_KERNELS = ("tri_pass", "entity_mesh_pass", "entity_mesh_rows", "tri_pass_multi",
               "tri_pass_f32", "entity_pass", "pixel_epilogue", "pixel_epilogue_nearest",
               "pixel_epilogue_f32", "tri_pass_ortho", "topview_epilogue",
               "topview_epilogue_nearest", "visible_ents")
# the layout-bank refresh: two small banks at B_REFRESH, rolled out
# REFRESH_HORIZON steps after a refresh from REFRESH_SEED
B_REFRESH, REFRESH_HORIZON, REFRESH_SEED = 1024, 8, 101

# the card's published peaks (H100 SXM data sheet) for the bound column
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# kernel vs plain on the card: both sides compute the same float32
# operations in the same order (the library is built with -fmad=false),
# so winners, depths and u8 colors are expected to agree exactly. tri_pass,
# entity_pass and pixel_epilogue are held to that: 0 pixels may differ.
# tri_pass builds timed beside the default one at the Maze's, Hallway's
# and PickupObjects' shapes: (TILE_W, TILE_H, PIX_PER_THREAD), each also
# held equal to the default
TILE_SWEEP = ((16, 12, 1), (16, 12, 2), (16, 12, 3), (16, 16, 1), (16, 16, 2),
              (8, 8, 1), (32, 12, 2), (32, 16, 2))

KERNELS = {
    "tri_pass": ("miniworld_tpu_torch/csrc/tri_pass.cu",
                 "miniworld_tpu/render/raycast.py:158"),
    "entity_pass": ("miniworld_tpu_torch/csrc/entity_pass.cu",
                    "miniworld_tpu/render/raycast.py:912"),
    "pixel_epilogue": ("miniworld_tpu_torch/csrc/pixel_epilogue.cu",
                       "miniworld_tpu/render/raycast.py:1244"),
    # fused: the tri_pass launch with mesh rows
    "entity_mesh_pass": ("miniworld_tpu_torch/csrc/tri_pass.cu",
                         "miniworld_tpu/render/raycast.py:838"),
    "place": ("miniworld_tpu_torch/csrc/place.cu",
              "miniworld_tpu/ops/place.py:65"),
    "mazegen": ("miniworld_tpu_torch/csrc/mazegen.cu",
                "miniworld_tpu/ops/mazegen.py:92"),
    # the in-step placement: CollectHealth's respawn calling place_one
    "place_one": ("miniworld_tpu_torch/csrc/place.cu",
                  "miniworld_tpu/envs/interact.py:200"),
    # the mesh entities' world-space rows, which the tri_pass launch reads
    "entity_mesh_rows": ("miniworld_tpu_torch/csrc/mesh_rows.cu",
                         "miniworld_tpu/render/raycast.py:747"),
}
MAZE_KERNELS = ("tri_pass", "entity_pass", "pixel_epilogue", "place", "mazegen")
# the top view's kernels (view="top") and the visibility query's
TOP_KERNELS = {
    "tri_pass_ortho": ("miniworld_tpu_torch/csrc/tri_pass_ortho.cu",
                       "miniworld_tpu/render/topview.py:155"),
    "topview_epilogue": ("miniworld_tpu_torch/csrc/topview_epilogue.cu",
                         "miniworld_tpu/render/topview.py:88"),
    "visible_ents": ("miniworld_tpu_torch/csrc/visible_ents.cu",
                     "miniworld_tpu/render/visibility.py:105"),
}
KERNEL_ORDER = {k: i for i, k in enumerate(KERNELS)}  # their rows in the kernels line
# (kernel, env id) -> the kernel's own device time per call, kernel_ms
DEVICE_MS: dict = {}


def say(phase: str, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


_LAP = [time.perf_counter(), time.perf_counter()]  # start of the run, of the phase


def lap(phase: str):
    """[time]: the host seconds since the last lap and since the start."""
    now = time.perf_counter()
    say("time", after=phase, seconds=f"{now - _LAP[1]:.1f}", total=f"{now - _LAP[0]:.1f}")
    _LAP[1] = now


# Before the first timing of the process, the timed function runs this
# long (wall clock), so that the card's clocks have ramped up under load;
# before every timing, WARMUP_CALLS times; a plain version timed over one
# call (hundreds of ms to seconds at the main paths' shapes) PLAIN_WARMUP
# times (none: the plain times are a comparison, not a measured path,
# and the seconds go to the later phases).
WARMUP_S = 1.0
WARMUP_CALLS = 3
PLAIN_WARMUP = 0
_CLOCKS_WARM = False


def cuda_ms(fn, iters: int, warmup_calls: int = WARMUP_CALLS) -> float:
    """Mean device time of fn() over ``iters`` runs, by CUDA events, after
    the warm-up (WARMUP_S the first time in the process, then
    ``warmup_calls`` calls)."""
    global _CLOCKS_WARM
    if not _CLOCKS_WARM:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < WARMUP_S:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        _CLOCKS_WARM = True
    for _ in range(warmup_calls):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int, name: str):
    """Mean device time per fn() of the kernels whose name contains
    ``name``, from torch.profiler over ``iters`` runs: the kernel alone,
    without the wrapper's host work and small torch ops, which the CUDA
    events of ``cuda_ms`` include where the host is the slower side.
    Every caller's fn() launches one such kernel: a window in which the
    profiler saw fewer than ``iters`` of them (it has missed all or some
    of a window's device events after another profile: one such window
    read 0.36 ms for a 1.8 ms launch) is profiled again, up to three
    windows; None where none was whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA and name in e.name]
        if len(evs) >= iters:
            return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / iters
    return None


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this smoke run needs a CUDA card")
    smi = card()
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        nvidia_smi=repr(smi))
    return smi


def phase_build():
    from miniworld_tpu_torch.render import cuda_build

    t0 = time.perf_counter()
    cuda_build.load()
    secs = time.perf_counter() - t0
    log = cuda_build.BUILD_INFO.get("log", "")
    with open(os.path.join(cuda_build.build_dir(), "kernel_build.log"), "w") as f:
        f.write(log)
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    spills = sorted({ln.strip() for ln in log.splitlines() if "spill" in ln})
    say("build", seconds=f"{secs:.2f}", arch="sm_90a",
        sources=",".join(cuda_build.SOURCES), ptxas=repr(" | ".join(regs)),
        ptxas_spills=repr(" | ".join(spills)))
    # the redesigned entity_pass, mazegen and visible_ents: no spills, and
    # mazegen's instances keep nothing in local memory (a 0-byte stack frame)
    props = ptxas_props(log)
    for fn, (frame, spill, regs_) in props.items():
        if any(k in fn for k in ("entity_pass", "mazegen", "visible_ents")):
            say("build-kernel", kernel=fn, registers=regs_, stack_frame_bytes=frame,
                spill_bytes=spill)
            if spill or ("mazegen" in fn and frame):
                raise AssertionError(f"{fn}: {frame} bytes stack frame, {spill} bytes spilled")


def ptxas_props(log):
    """{entry function: (stack frame bytes, spill store + load bytes,
    registers)} from a ptxas -v log."""
    props, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", ln)
        if m and fn is not None:
            props[fn] = (int(m.group(1)), int(m.group(2)) + int(m.group(3)), None)
        r = re.search(r"Used (\d+) registers", ln)
        if r and fn in props:
            props[fn] = props[fn][:2] + (int(r.group(1)),)
    return props


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version


def spread_states(env, gen, lo, hi, seed=7):
    """States from a reset with the agents spread uniformly over the box
    [lo, hi] (x, z), each at a uniform yaw; entities where reset put
    them."""
    state, _ = env.reset(seed=seed)
    n = env.num_envs
    u = torch.rand((n, 3), generator=gen).to(env.device)
    pos = torch.stack([lo[0] + (hi[0] - lo[0]) * u[:, 0], torch.zeros_like(u[:, 0]),
                       lo[1] + (hi[1] - lo[1]) * u[:, 1]], dim=1)
    return state.replace(pos=pos, dir=(u[:, 2] * 2.0 - 1.0) * math.pi)


def wide_inputs(dev, gen, n=64, S=64, E=4, L=2, A=96, K=16):
    """Synthetic wide case: S prims of mixed kind around each camera,
    E entities of mixed shape (some inactive), slots incl. -1 and A. The
    96-slot atlas's Fourier table (57 KB) is too large for the epilogue
    kernel's shared memory: it takes the path that reads the table by
    slot through L1."""
    from miniworld_tpu_torch.ops import geom
    from miniworld_tpu_torch.render import raycast as rc

    def rnd(*shape):
        return torch.rand(shape, generator=gen)

    v0 = torch.stack([rnd(L, S) * 12 - 6, rnd(L, S) * 3, rnd(L, S) * 12 - 6], 1)
    e1 = (rnd(L, 3, S) - 0.5) * 4
    e2 = (rnd(L, 3, S) - 0.5) * 4
    verts9 = torch.cat([v0, v0 + e1, v0 + e2], 1).contiguous()  # (L, 9, S)
    attr = (rnd(L, S, 16) - 0.5) * 2
    attr[:, :, 11:14] = rnd(L, S, 3)
    slot = torch.randint(-1, A + 1, (L, S), generator=gen).float()
    attr[:, :, 14] = slot
    attr[:, :, 15] = (rnd(L, S) > 0.5).float()
    layout_id = torch.randint(0, L, (n,), generator=gen, dtype=torch.int32)
    yaw = (rnd(n) * 2 - 1) * math.pi
    pitch = (rnd(n) - 0.5) * 20
    fwd, up, right = [t.to(dev) for t in geom.cam_basis(yaw, pitch)]
    origin = torch.stack([rnd(n) * 4 - 2, 1.5 + rnd(n) * 0.2, rnd(n) * 4 - 2], 1)
    tan_y = torch.full((n,), math.tan(math.radians(30.0)))
    xbase = 2.0 * (torch.arange(W, dtype=torch.float32) + 0.5) * (1.0 / W) - 1.0
    ybase = 1.0 - 2.0 * (torch.arange(H, dtype=torch.float32) + 0.5) * (1.0 / H)
    cam = rc.Camera(origin.to(dev), fwd, right, up, (tan_y * (W / H)).to(dev),
                    tan_y.to(dev), xbase.to(dev), ybase.to(dev))
    ent_pos = torch.stack([rnd(n, E) * 8 - 4, rnd(n, E) * 0.5, rnd(n, E) * 8 - 4], -1)
    ent_size = 0.3 + rnd(n, E, 3)
    ent_dir = (rnd(n, E) * 2 - 1) * math.pi
    ent_height = 0.3 + rnd(n, E)
    ent_color = rnd(n, E, 3)
    kind = torch.randint(0, 2, (n, E), generator=gen)
    active = rnd(n, E) > 0.2
    flags = (active.to(torch.uint8) * rc.ENT_ACTIVE
             + (kind == 0).to(torch.uint8) * rc.ENT_SPHERE
             + (kind == 1).to(torch.uint8) * rc.ENT_BOX)
    ents = [t.to(dev).contiguous() for t in
            (ent_pos, ent_size, ent_dir, ent_height, ent_color, flags)]
    atlas = rnd(A, 4 + 8 * K)
    atlas[:, 3:3 + 2 * K] = torch.randint(-8, 9, (A, 2 * K), generator=gen).float()
    atlas[:, -1] = 1.0
    lights = [torch.tensor(v).expand(n, 3).contiguous().to(dev) for v in
              ([0.0, 2.5, 0.0], [0.7, 0.7, 0.7], [0.45, 0.45, 0.45], [0.25, 0.82, 1.0])]
    return (verts9.to(dev), attr.to(dev), layout_id.to(dev), cam, ents,
            atlas.to(dev), lights, K, rc.fourier_table(atlas, K).to(dev))


def grazing_case(n, tile, n_rows=1024, seed=11):
    """Synthetic rows at the edges of tri_pass's cull margins, each env
    (layout_id = arange(n)) with rows made for its own camera: vertices
    on the rays through the centres of tile-corner pixels (edges through
    those centres, both windings, quads and triangles), tiny triangles
    whose det at a corner pixel is 0.5-2 x 1e-12, and rows at t = NEAR
    and t = FAR times 1 +- 1e-6. numpy draws from ``seed``, built in
    float64 and rounded to float32, on the CPU: (verts9 (n, 9, S), attr
    (n, S, 16), layout_id (n,) i32, cam)."""
    from miniworld_tpu_torch.ops import geom
    from miniworld_tpu_torch.render import raycast as rc

    rng = np.random.default_rng(seed)
    tw, th = tile
    width, height = W, H
    yaw = torch.from_numpy(rng.uniform(-np.pi, np.pi, n).astype(np.float32))
    pitch = torch.from_numpy(rng.uniform(-15.0, 15.0, n).astype(np.float32))
    fwd, up, right = geom.cam_basis(yaw, pitch)
    origin = np.stack([rng.uniform(-2, 2, n), np.full(n, 1.5), rng.uniform(-2, 2, n)], 1)
    tan_y = torch.full((n,), math.tan(math.radians(30.0)))
    xbase = 2.0 * (torch.arange(width, dtype=torch.float32) + 0.5) * (1.0 / width) - 1.0
    ybase = 1.0 - 2.0 * (torch.arange(height, dtype=torch.float32) + 0.5) * (1.0 / height)
    cam = rc.Camera(torch.from_numpy(origin.astype(np.float32)), fwd, right, up,
                    tan_y * (width / height), tan_y, xbase, ybase)
    xv, yv = cam.xv().double().numpy(), cam.yv().double().numpy()  # (n, HW)
    basis = [t.double().numpy() for t in (fwd, right, up)]
    cols = sorted({x for x0 in range(0, width, tw) for x in (x0, min(x0 + tw, width) - 1)})
    rows_y = sorted({y for y0 in range(0, height, th) for y in (y0, min(y0 + th, height) - 1)})

    def corner_rays():  # (n, 3) direction through a random tile-corner pixel per env
        p = (rng.choice(rows_y, n) * width + rng.choice(cols, n))
        a, b = xv[np.arange(n), p], yv[np.arange(n), p]
        return basis[0] + a[:, None] * basis[1] + b[:, None] * basis[2]

    verts = np.zeros((n, n_rows, 3, 3))
    kinds = rng.integers(0, 2, (n, n_rows)).astype(np.float64)
    for s in range(n_rows):
        d0, d1, d2 = corner_rays(), corner_rays(), corner_rays()
        style = s % 4
        if style == 3:  # near or far
            base = 0.04 if rng.uniform() < 0.5 else 100.0
            t = base * (1.0 + rng.choice([-1e-6, 1e-6], (n, 1)))
        else:
            t = rng.uniform(0.5, 20.0, (n, 1))
        v = [origin + t * d for d in (d0, d1, d2)]
        if style == 2:  # tiny triangle: det = (e2 x e1) . d0 near 1e-12 at the corner
            e1, e2 = v[1] - v[0], v[2] - v[0]
            det = np.einsum("ni,ni->n", np.cross(e2, e1), d0)
            scale = np.sqrt(rng.choice([0.5, 1.0, 2.0], n) * 1e-12 / np.maximum(np.abs(det), 1e-30))
            sign = np.where(det < 0, -1.0, 1.0)  # flip e2 to face the camera
            v = [v[0], v[0] + e1 * scale[:, None], v[0] + sign[:, None] * e2 * scale[:, None]]
            kinds[:, s] = 1.0
        verts[:, s] = np.stack(v, 1)
    verts9 = torch.from_numpy(verts.reshape(n, n_rows, 9).transpose(0, 2, 1)
                              .astype(np.float32)).contiguous()
    attr = rng.uniform(-1, 1, (n, n_rows, 16)).astype(np.float32)
    attr[:, :, 14] = rng.integers(-1, 6, (n, n_rows))
    attr[:, :, 15] = kinds
    return (verts9, torch.from_numpy(attr), torch.arange(n, dtype=torch.int32), cam)


def compare_hits(t_k, t_p, same):
    """Winner-differs pixel count and fraction, and the max abs / rel
    error of the hit distance t where the winners (``same``) agree."""
    both_miss = torch.isinf(t_k) & torch.isinf(t_p)
    same = same & (both_miss | (torch.isfinite(t_k) & torch.isfinite(t_p)))
    fin = same & ~both_miss
    diff = (t_k - t_p).abs()[fin]
    rel = (diff / t_p[fin].abs()) if diff.numel() else diff
    abs_err = float(diff.max()) if diff.numel() else 0.0
    rel_err = float(rel.max()) if rel.numel() else 0.0
    return int((~same).sum()), 1.0 - float(same.float().mean()), abs_err, rel_err


def check_stage(name, case, n_differ, differ, abs_err, rel_err):
    """Raises where any pixel's winner or t differs between the kernel's
    hits and the plain version's (compare_hits' counts)."""
    say("kernel-vs-plain", kernel=name, case=case, winner_differs_px=n_differ,
        winner_differs=f"{differ:.3e}", t_max_abs_err=f"{abs_err:.3e}",
        t_max_rel_err=f"{rel_err:.3e}", exact=True)
    if n_differ or abs_err:
        raise AssertionError(f"{name} ({case}): kernel differs from plain on {n_differ} "
                             f"pixels, t by up to {abs_err:.3e}")


def check_entity_pass(e_k, e_p, case):
    """The entity_pass kernel's (t, colour, normal) against its plain
    version's, exactly under its contract: t at every sample (bits),
    colour and normal wherever the plain t is finite (the kernel leaves
    them unwritten elsewhere). Returns the max abs t error."""
    t_k, t_p = e_k[0], e_p[0]
    attrs = (e_k[1] == e_p[1]).all(-1) & (e_k[2] == e_p[2]).all(-1)
    same = (t_k.view(torch.int32) == t_p.view(torch.int32)) & (~torch.isfinite(t_p) | attrs)
    n_differ, differ, abs_err, rel_err = compare_hits(t_k, t_p, same)
    check_stage("entity_pass", case, n_differ, differ, abs_err, rel_err)
    return abs_err


def ent_work(flags, t_ent, width, height):
    """((bytes, operations), (bytes, full-scan operations)) of an
    entity_pass launch whose plain version returns t ``t_ent`` (B, HW) on
    a width x height grid of samples: the per-entity inputs (45 bytes a
    slot) and the camera read once, t written at every sample (4 bytes)
    and colour and normal (24) at each sample the plain version hits.
    Operations: one test of the winning slot at each hit sample (20 for a
    sphere, 45 for a box slab test; an env with an active sphere counted
    at 20), and for the full scan every (sample, active slot) pair, as the
    kernel before the cull tested them."""
    from miniworld_tpu_torch.render.raycast import ENT_ACTIVE, ENT_BOX, ENT_SPHERE

    b, hws = t_ent.shape
    active = (flags & ENT_ACTIVE) != 0
    sph = active & ((flags & ENT_SPHERE) != 0)
    box = active & ((flags & ENT_BOX) != 0) & ~sph
    hits = torch.isfinite(t_ent).sum(1)
    per_hit = torch.where(sph.any(1), 20, 45)
    nbytes = (b * flags.shape[1] * 45 + b * 14 * 4 + (width + height) * 4 + b * hws * 4
              + int(hits.sum()) * 24)
    return ((nbytes, int((hits * per_hit).sum())),
            (nbytes, hws * (int(sph.sum()) * 20 + int(box.sum()) * 45)))


def plain_tri_pass(tri_args, mesh=None, paired=None, tri_chunk=None, override=None,
                   attr_dtype=torch.bfloat16, active=None):
    """tri_pass's plain version on these inputs: tri_pass_plain (seeded by
    the mesh pass on ``mesh`` rows), tri_pass_chunked over more than
    one chunk of ``tri_chunk``, or tri_pass_scheduled for a (B, n)
    schedule in place of layout_id (seeded likewise); ``override``: every
    row's texture variant in its slot column; ``attr_dtype``: the carry;
    ``active``: the dense super bank's kill."""
    from miniworld_tpu_torch.render import raycast as rc

    verts9, attr, layout_id, cam, all_quads = tri_args
    sched = layout_id.dim() == 2
    if not sched and tri_chunk is not None and verts9.shape[2] > tri_chunk:
        return rc.tri_pass_chunked(verts9, attr, layout_id, cam, tri_chunk, all_quads,
                                   override, paired, attr_dtype, active)
    seed = None if mesh is None else rc.entity_mesh_pass_plain(*mesh, cam, attr_dtype)
    if sched:
        return rc.tri_pass_scheduled(verts9, attr, layout_id, cam, all_quads, seed, override,
                                     attr_dtype)
    return rc.tri_pass_plain(verts9, attr, layout_id, cam, all_quads, seed, paired, override,
                             attr_dtype, active)


def check_tri_pass(tri_args, case, mesh=None, paired=None, tri_chunk=None, override=None,
                   attr_dtype=torch.bfloat16, active=None):
    """The tri_pass kernel against its plain version on every pixel (t
    and attributes); with ``mesh`` rows the fused launch against the mesh
    pass seeding tri_pass_plain; over more than one chunk of
    ``tri_chunk`` the multi-chunk launch against tri_pass_chunked; over a
    (B, n) schedule the SCHED launch against tri_pass_scheduled; with
    ``override`` the winner's texture variant against every row's;
    ``attr_dtype`` the carry; ``active`` the dense super bank's kill.
    Returns (t, attr, max abs t error)."""
    from miniworld_tpu_torch.render import raycast as rc

    verts9, attr, layout_id, cam, all_quads = tri_args
    t_k, a_k = rc.tri_pass(verts9, attr, layout_id, cam, all_quads, mesh, paired, tri_chunk,
                           override, attr_dtype, active)
    t_p, a_p = plain_tri_pass(tri_args, mesh, paired, tri_chunk, override, attr_dtype, active)
    n_differ, differ, abs_err, rel_err = compare_hits(t_k, t_p, (a_k == a_p).all(-1))
    sched = layout_id.dim() == 2
    multi = not sched and tri_chunk is not None and verts9.shape[2] > tri_chunk
    check_stage("tri_pass" + (" mesh" if mesh else "") + (" paired" if paired else "")
                + (" multi-chunk" if multi else "") + (" sched" if sched else "")
                + (" override" if override else "")
                + (" f32" if attr_dtype == torch.float32 else "")
                + (" active" if active is not None else ""),
                case, n_differ, differ, abs_err, rel_err)
    return t_k, a_k, abs_err


def run_stage_checks(tri_args, ent_args, epi_rest, case, timings=None, mesh=None,
                     paired=None, plain_iters=5, tri_chunk=None):
    """Each render stage's kernel against its plain version on one set of
    inputs; ``mesh`` = (rows9, row_attrs) gives tri_pass mesh rows (the
    plain side: the mesh pass seeding tri_pass_plain); ``paired`` makes
    tri_pass read a paired procgen bank. With ``timings`` each stage is
    also timed by CUDA events, the kernel over 50 runs and the plain
    version over ``plain_iters``; with mesh rows also tri_pass without
    them ("tri_pass_unmeshed"). ``tri_chunk``: tri_pass scans the rows in
    chunks of it (the multi-chunk launch above one chunk). ``ent_args``
    None: no analytic entity (CollectHealth), no entity_pass."""
    from miniworld_tpu_torch.render import raycast as rc

    verts9, attr, layout_id, cam, all_quads = tri_args
    out = {}
    t_k, a_k, out["tri_pass"] = check_tri_pass(tri_args, case, mesh, paired, tri_chunk)
    if mesh is not None:
        out["entity_mesh_pass"] = out["tri_pass"]

    if ent_args is None:  # no analytic entity: the render runs no entity_pass
        e_k = (None, None, None)
    else:
        ent, has_sphere, has_box = ent_args
        e_k = rc.entity_pass(*ent, cam, has_sphere, has_box)
        e_p = rc.entity_pass_plain(*ent, cam, has_sphere, has_box)
        out["entity_pass"] = check_entity_pass(e_k, e_p, case)

    atlas, lights, k_terms, table = epi_rest
    # both epilogue versions read the kernels' hit results; the kernel
    # reads the atlas's Fourier table, the plain version the atlas
    rgb_k, d_k = rc.pixel_epilogue(t_k, a_k, *e_k, atlas, cam, *lights, k_terms, table=table)
    rgb_p, d_p = rc.pixel_epilogue_plain(t_k, a_k, *e_k, atlas, cam, *lights, k_terms)
    diff = (rgb_k.int() - rgb_p.int()).abs()
    rgb_err = int(diff.max())
    n_rgb = int((diff.amax(-1) > 0).sum())
    frac = n_rgb / diff[..., 0].numel()
    d_err = float(((d_k - d_p).abs() / d_p.abs()).max())
    n_depth = int((d_k != d_p).sum())
    say("kernel-vs-plain", kernel="pixel_epilogue", case=case, max_rgb_err=rgb_err,
        rgb_differs_px=n_rgb, rgb_differs=f"{frac:.3e}", depth_differs_px=n_depth,
        depth_max_rel_err=f"{d_err:.3e}", exact=True)
    if n_rgb or n_depth:
        raise AssertionError(f"pixel_epilogue ({case}): kernel differs from plain on "
                             f"{n_rgb} RGB and {n_depth} depth pixels")
    out["pixel_epilogue"] = float(rgb_err)

    if timings is not None:  # at the main path's shapes
        timings["tri_pass"] = (
            cuda_ms(lambda: rc.tri_pass(verts9, attr, layout_id, cam, all_quads, mesh,
                                        paired, tri_chunk), 50),
            cuda_ms(lambda: plain_tri_pass(tri_args, mesh, paired, tri_chunk), plain_iters,
                    PLAIN_WARMUP))
        if mesh is not None:
            DEVICE_MS[("tri_pass", "mesh")] = kernel_ms(
                lambda: rc.tri_pass(verts9, attr, layout_id, cam, all_quads, mesh, paired), 50,
                "tri_pass_kernel")
            timings["tri_pass_unmeshed"] = (
                cuda_ms(lambda: rc.tri_pass(verts9, attr, layout_id, cam, all_quads, None,
                                            paired), 50),
                cuda_ms(lambda: rc.tri_pass_plain(verts9, attr, layout_id, cam, all_quads,
                                                  paired=paired), plain_iters, PLAIN_WARMUP))
        if ent_args is not None:
            timings["entity_pass"] = (
                cuda_ms(lambda: rc.entity_pass(*ent, cam, has_sphere, has_box), 50),
                cuda_ms(lambda: rc.entity_pass_plain(*ent, cam, has_sphere, has_box),
                        plain_iters, PLAIN_WARMUP),
                kernel_ms(lambda: rc.entity_pass(*ent, cam, has_sphere, has_box), 50,
                          "entity_pass_kernel"))
        timings["pixel_epilogue"] = (
            cuda_ms(lambda: rc.pixel_epilogue(t_k, a_k, *e_k, atlas, cam, *lights,
                                              k_terms, table=table), 50),
            cuda_ms(lambda: rc.pixel_epilogue_plain(t_k, a_k, *e_k, atlas, cam,
                                                    *lights, k_terms), plain_iters, PLAIN_WARMUP))
    return out, (t_k, a_k, e_k)


def wide_mesh_rows(cam, gen, n_rows=1000):
    """Synthetic mesh rows beside wide_inputs' prims: 1000 triangles per
    env (close to the z-key's 1024-row budget) around each camera, 20%
    of them inactive (all-zero vertices, as entity_mesh_rows leaves
    them), 10% pushed far behind the camera, slots incl. -1 and 6."""
    dev = cam.origin.device
    b = cam.origin.shape[0]

    def rnd(*shape):
        return torch.rand(shape, generator=gen)

    v0 = torch.stack([rnd(b, n_rows) * 12 - 6, rnd(b, n_rows) * 3,
                      rnd(b, n_rows) * 12 - 6], 1)
    e1 = (rnd(b, 3, n_rows) - 0.5) * 2
    e2 = (rnd(b, 3, n_rows) - 0.5) * 2
    verts9 = torch.cat([v0, v0 + e1, v0 + e2], 1)  # (b, 9, n)
    behind = (rnd(b, 1, n_rows) < 0.1).expand(b, 9, n_rows)
    verts9 = torch.where(behind, verts9 - 400.0 * cam.fwd.cpu().repeat(1, 3)[:, :, None],
                         verts9)
    inactive = (rnd(b, 1, n_rows) < 0.2).expand(b, 9, n_rows)
    verts9 = torch.where(inactive, torch.zeros_like(verts9), verts9)
    attrs = (rnd(b, n_rows, 16) - 0.5) * 2
    attrs[:, :, 11:14] = rnd(b, n_rows, 3)
    attrs[:, :, 14] = torch.randint(-1, 7, (b, n_rows), generator=gen).float()
    attrs[:, :, 15] = 1.0
    return verts9.to(dev).contiguous(), attrs.to(dev).contiguous()


def facing_states(env, gen, lo, hi, seed=7):
    """States from a reset with the agents spread uniformly over the box
    [lo, hi] (x, z), env i looking towards its entity slot i mod E, so
    most frames show entities against walls, floor and sky."""
    state, _ = env.reset(seed=seed)
    n = env.num_envs
    u = torch.rand((n, 2), generator=gen).to(env.device)
    pos = torch.stack([lo[0] + (hi[0] - lo[0]) * u[:, 0], torch.zeros_like(u[:, 0]),
                       lo[1] + (hi[1] - lo[1]) * u[:, 1]], dim=1)
    slot = torch.arange(n, device=env.device) % state.ent_pos.shape[1]
    target = state.ent_pos[torch.arange(n, device=env.device), slot]
    # forward is (cos d, 0, -sin d)
    yaw = torch.atan2(-(target[:, 2] - pos[:, 2]), target[:, 0] - pos[:, 0])
    return state.replace(pos=pos, dir=yaw)


def stage_inputs(env, state):
    from miniworld_tpu_torch.render import raycast as rc

    cam = rc.camera_grid(state, W, H)
    tri = (env._bank.tri_verts9, env._bank.tri_attr, state.layout_id, cam, env._all_quads)
    ent = ((state.ent_pos, state.ent_size, state.ent_dir, state.ent_height,
            state.ent_color, rc.entity_flags(env._bank, state)), *env._shapes_present[:2])
    epi = (env._atlas, (state.light_pos, state.light_color, state.light_ambient,
                        state.sky_color), env.fourier_k, env._fourier_table)
    return cam, tri, ent, epi


def phase_kernels(hall, pick):
    """Every kernel against its plain version: Hallway's shapes and the
    wide case (the Hallway slice's checks), then PickupObjects' shapes
    at B=4096 with mesh rows in the tri_pass launch, timed there, and a
    wide mesh case."""
    from miniworld_tpu_torch.render import raycast as rc

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(1234)
    tile = rc.tri_pass_tile()[:2]
    state = spread_states(hall, gen, (-0.5, -1.5), (10.5, 1.5))
    _, tri, ent, epi = stage_inputs(hall, state)
    errs, outs = run_stage_checks(
        tri, ent, epi, f"hallway B={B} HW={W * H} S={tri[0].shape[2]} "
        f"E={state.ent_pos.shape[1]}")
    # tri_pass at Hallway's shapes: 8 rows, where culling saves nothing
    stats = tri_cull_stats(tri, tile=tile)
    work = stage_work(hall, state, tri, ent, outs, stats["hit_pairs"])
    say("tri-cull", env=ENV_ID, B=B, **cull_fields(stats, tile, tri[0].shape[2]))
    hall_ms = (cuda_ms(lambda: rc.tri_pass(*tri), 50), cuda_ms(lambda: rc.tri_pass_plain(*tri), 5))
    say("kernel-time", kernel="tri_pass", ms=f"{hall_ms[0]:.4f}", plain_ms=f"{hall_ms[1]:.4f}",
        bound_ms=f"{bound(*work['tri_pass'])[0]:.4f}",
        bound_full_scan_ms=f"{bound(*work['tri_pass_full_scan'])[0]:.4f}",
        shapes=f"{ENV_ID} B={B} HW={W * H}")
    errs["tri_pass"] = max(errs["tri_pass"], phase_grazing(dev, tile))
    sweep = [(f"{ENV_ID} B={B}", lambda tri=tri: rc.tri_pass(*tri), outs[:2])]
    verts9, attr, layout_id, wcam, ents, atlas, lights, k_terms, table = wide_inputs(dev, gen)
    wide_case = ((verts9, attr, layout_id, wcam, False), (ents, True, True),
                 (atlas, lights, k_terms, table))
    wide, _ = run_stage_checks(*wide_case, "wide B=64 S=64 mixed-kind E=4 spheres+boxes slot<0")
    errs = {k: max(errs[k], wide[k]) for k in errs}

    # PickupObjects at the main path's shapes: spheres analytic, boxes
    # and keys as mesh rows in the tri_pass launch
    state = facing_states(pick, gen, (0.5, 0.5), (11.5, 11.5))
    cam, tri, ent, epi = stage_inputs(pick, state)
    rows9, row_attrs, valid = rc.entity_mesh_rows(pick._bank, state)
    timings = {}
    p_errs, outs = run_stage_checks(
        tri, ent, epi, f"pickupobjects B={B_PICK} HW={W * H} S={tri[0].shape[2]} "
        f"E*M={rows9.shape[2]}", timings, mesh=(rows9, row_attrs))
    mesh_t = rc.entity_mesh_pass_plain(rows9, row_attrs, cam)[0]
    say("pickup-scene", px_hit=f"{float(torch.isfinite(outs[0]).float().mean()):.3f}",
        px_mesh_hit=f"{float(torch.isfinite(mesh_t).float().mean()):.4f}",
        frames_showing_mesh=f"{float(torch.isfinite(mesh_t).any(1).float().mean()):.3f}",
        live_mesh_rows=int(valid.sum()))
    errs = {k: max(errs.get(k, 0.0), v) for k, v in p_errs.items()}
    mesh = wide_mesh_rows(wcam, gen)
    w_errs, _ = run_stage_checks(
        *wide_case, "wide-mesh B=64 E*M=1000 (20% inactive, 10% behind) with S=64",
        mesh=mesh)
    errs = {k: max(errs[k], v) for k, v in w_errs.items()}
    stats = tri_cull_stats(tri, tile=tile)
    say("tri-cull", env=PICK_ID, B=B_PICK, **cull_fields(stats, tile, tri[0].shape[2]))
    m_stats = tri_cull_stats(tri, tile=tile, mesh_rows9=rows9)
    say("tri-cull", env=PICK_ID, B=B_PICK, mesh_rows="yes",
        **cull_fields(m_stats, tile, rows9.shape[2]))
    work = stage_work(pick, state, tri, ent, outs, stats["hit_pairs"],
                      mesh=(rows9, m_stats["hit_pairs"]))
    work["tri_pass_unmeshed"] = stage_work(pick, state, tri, ent, outs,
                                           stats["hit_pairs"])["tri_pass"]
    mesh = (rows9, row_attrs)
    sweep.append((f"{PICK_ID} B={B_PICK} mesh", lambda tri=tri: rc.tri_pass(*tri, mesh),
                  outs[:2]))
    return errs, timings, work, sweep


def phase_grazing(dev, tile, n=64, n_rows=1024):
    """tri_pass against its plain version on rows that graze the cull's
    margins (grazing_case, 1024 rows: the launch above 48 KB of shared
    memory), quads only and mixed, then with the same 1024 rows of each
    env also as its mesh rows (106 KB of shared memory; mesh and static
    rows tie in quantized depth wherever both hit); returns the max abs t
    error."""
    from miniworld_tpu_torch.render import raycast as rc

    verts9, attr, layout_id, cam = grazing_case(n, tile, n_rows)
    verts9, attr, layout_id = verts9.to(dev), attr.to(dev), layout_id.to(dev)
    cam = rc.Camera(*(t.to(dev) for t in cam))
    err = 0.0
    for all_quads in (False, True):
        t_k, a_k = rc.tri_pass(verts9, attr, layout_id, cam, all_quads)
        t_p, a_p = rc.tri_pass_plain(verts9, attr, layout_id, cam, all_quads)
        n_differ, differ, abs_err, rel_err = compare_hits(t_k, t_p, (a_k == a_p).all(-1))
        check_stage("tri_pass", f"grazing B={n} S={n_rows} tile={tile[0]}x{tile[1]} "
                    f"all_quads={all_quads} px_hit={float(torch.isfinite(t_p).float().mean()):.3f}",
                    n_differ, differ, abs_err, rel_err)
        err = max(err, abs_err)
        # each env's rows (layout_id = arange(n)) are its mesh rows too
        err = max(err, check_tri_pass(
            (verts9, attr, layout_id, cam, all_quads),
            f"grazing B={n} S={n_rows} N={n_rows} (the same rows) tile={tile[0]}x{tile[1]} "
            f"all_quads={all_quads}", mesh=(verts9, attr))[2])
    return err


def cam_rows(cam, sl):
    """The cameras of envs ``sl``."""
    from miniworld_tpu_torch.render import raycast as rc

    return rc.Camera(*(t[sl] for t in cam[:6]), cam.xbase, cam.ybase)


def tri_cull_stats(tri, paired=None, tile=None, block=32, mesh_rows9=None):
    """What tri_pass's rows do on these inputs, from the plain versions
    over blocks of envs: the (row, pixel) pairs that pass the hit test,
    and with ``tile`` = (w, h) the kernel's culling — the rows a frame
    keeps after the image test, the survivors per tile and the rows a
    pixel scans (its tile's survivors), as means. With ``mesh_rows9``
    (B, 9, N), the same for those mesh rows, as the kernel stages them."""
    from miniworld_tpu_torch.render import raycast as rc

    verts9, attr, layout_id, cam, all_quads = tri
    b = layout_id.shape[0]
    out = dict(hit_pairs=0, image=0.0, tiles=0.0, scanned=0.0)
    if layout_id.dim() == 2 and mesh_rows9 is None:  # a schedule: each chunk at its first
        if tile is not None or paired is not None:  # position, hits only
            raise ValueError("tri_cull_stats counts only the hits of a schedule")
        first = torch.ones_like(layout_id, dtype=torch.bool)
        for j in range(1, layout_id.shape[1]):
            first[:, j] = (layout_id[:, :j] != layout_id[:, j:j + 1]).all(1)
        for lo in range(0, b, block):
            sl = slice(lo, lo + block)
            c = cam_rows(cam, sl)
            for j in range(layout_id.shape[1]):
                rows = rc.stage_rows(verts9, attr, layout_id[sl, j], c)
                hits = rc.row_hits_plain(rows, c, all_quads).sum((1, 2))
                out["hit_pairs"] += int((hits * first[sl, j]).sum())
        return dict(hit_pairs=out["hit_pairs"],
                    hits_per_px=out["hit_pairs"] / (b * cam.width * cam.height))
    if tile is not None:
        tw, th = tile
        cols = torch.tensor([min(tw, W - x) for x in range(0, W, tw)], dtype=torch.float64)
        rows_px = torch.tensor([min(th, H - y) for y in range(0, H, th)], dtype=torch.float64)
        px = (rows_px[:, None] * cols[None, :]).reshape(-1).to(verts9.device)  # (T,)
    for lo in range(0, b, block):
        sl = slice(lo, lo + block)
        c = cam_rows(cam, sl)
        p = None if paired is None else (*paired[:3], paired[3][sl])
        if mesh_rows9 is None:
            rows, quads = rc.stage_rows(verts9, attr, layout_id[sl], c, p), all_quads
        else:
            rows, quads = rc.stage_mesh_rows(mesh_rows9[sl], c), False
        out["hit_pairs"] += int(rc.row_hits_plain(rows, c, quads).sum())
        if tile is not None:
            per_tile = rc.tile_cull_plain(rows, c, tw, th, quads).sum(2).double()
            out["tiles"] += float(per_tile.mean(1).sum())
            out["scanned"] += float((per_tile * px).sum())
            out["image"] += float(rc.tile_cull_plain(rows, c, W, H, quads).sum())
    return dict(hit_pairs=out["hit_pairs"], hits_per_px=out["hit_pairs"] / (b * W * H),
                image_survivors=out["image"] / b, survivors_per_tile=out["tiles"] / b,
                scanned_per_px=out["scanned"] / (b * W * H))


def image_survivors(tri, paired=None, block=64):
    """(B,) rows of each env that survive tri_pass's cull against its
    whole image (the rows the multi-chunk kernel streams through its
    window), from the plain cull over blocks of envs."""
    from miniworld_tpu_torch.render import raycast as rc

    verts9, attr, layout_id, cam, all_quads = tri
    out = []
    for lo in range(0, layout_id.shape[0], block):
        sl = slice(lo, lo + block)
        c = cam_rows(cam, sl)
        p = None if paired is None else (*paired[:3], paired[3][sl])
        rows = rc.stage_rows(verts9, attr, layout_id[sl], c, p)
        out.append(rc.tile_cull_plain(rows, c, c.width, c.height, all_quads)[:, 0].sum(1))
    return torch.cat(out)


def windows_all_in_view(n_rows):
    """The windows the multi-chunk kernel scans an env in when all of its
    ``n_rows`` rows survive the image cull: batches of its block's
    threads, a batch that would overflow the window closing it first."""
    from miniworld_tpu_torch.render import raycast as rc

    tw, th, k = rc.tri_pass_tile()
    gx, gy, rows = rc.tri_pass_window()
    block = tw * th // k * gx * gy
    n_win, windows = 0, 1
    for s0 in range(0, n_rows, block):
        total = min(block, n_rows - s0)
        if n_win + total > rows:
            windows, n_win = windows + 1, 0
        n_win += total
    return windows


def say_window(label, tri, paired=None):
    """[tri-window]: the multi-chunk kernel's window against these views'
    image survivors: their mean and max, and the envs that need more than
    one window."""
    from miniworld_tpu_torch.render import raycast as rc

    gx, gy, rows = rc.tri_pass_window()
    n = image_survivors(tri, paired).double()
    say("tri-window", env=label, B=n.numel(), group=f"{gx}x{gy}", window_rows=rows,
        image_survivors_mean=f"{float(n.mean()):.1f}", image_survivors_max=int(n.max()),
        envs_over_one_window=int((n > rows).sum()))


def cull_fields(stats, tile, n_rows):
    return dict(tile=f"{tile[0]}x{tile[1]}", rows=n_rows,
                rows_after_image_test=f"{stats['image_survivors']:.3f}",
                survivors_per_tile=f"{stats['survivors_per_tile']:.3f}",
                rows_scanned_per_px=f"{stats['scanned_per_px']:.3f}",
                hit_rows_per_px=f"{stats['hits_per_px']:.4f}")


def stage_work(env, state, tri, ent, outs, tri_hits, mesh=None, paired=None):
    """(bytes, float operations) each render stage must move and do on
    these inputs: each input read once, each output written once;
    operations counted per (row, pixel) pair that the data needs (live
    mesh rows, active entities, textured pixels; for tri_pass the
    ``tri_hits`` pairs that pass the hit test, tri_cull_stats, and under
    "tri_pass_full_scan" every (row, pixel) pair, as a full scan tests them).
    Per-pair counts:
    separable hit test 22 (three 2-term contractions 12, 1/t 1, coverage
    3, gates 6), triangle-only 20, the entity pass as ent_work counts it,
    Fourier texel 41 per term (phase 3, cos/sin 20, anti-aliasing 6,
    amplitudes 12) plus 60 per pixel for uv, lighting and the pack.
    ``mesh`` = (rows9, mesh_hits) adds the mesh rows to the tri_pass
    launch (their bytes, 20 operations per (mesh row, pixel) pair that
    passes the hit test), also as "entity_mesh_pass"; ``paired`` =
    tri_pass's paired inputs (both variants' rows, the row walls and the
    envs' mazes)."""
    b, hw = state.pos.shape[0], W * H
    cam_b = b * 14 * 4 + (W + H) * 4
    verts9, attr, _, _, _ = tri
    L, _, S = verts9.shape
    t_k, a_k, e_k = outs
    tri_bytes = L * S * (9 + 16) * 4 + b * 4 + cam_b + b * hw * 36
    if paired is not None:
        tri_bytes += sum(t.numel() * t.element_size() for t in paired)
    work = {}
    tri_ops = tri_hits * 22 + b * hw
    full_scan_ops = b * hw * (S * 22 + 1)
    if mesh is not None:
        rows9, mesh_hits = mesh
        n_rows = rows9.shape[2]
        tri_bytes += b * n_rows * (9 + 16) * 4
        tri_ops += mesh_hits * 20
        full_scan_ops += b * hw * n_rows * 20
    work["tri_pass"] = (tri_bytes, tri_ops)
    work["tri_pass_full_scan"] = (tri_bytes, full_scan_ops)
    if mesh is not None:
        work["entity_mesh_pass"] = work["tri_pass"]
    if ent is not None:
        work["entity_pass"], work["entity_pass_full_scan"] = ent_work(ent[0][5], e_k[0], W, H)
    k = env.fourier_k
    read, textured = texel_reads(t_k, a_k, e_k[0], env._fourier_table.shape[0])
    work["pixel_epilogue"] = (b * hw * 4 + read * 32 + ent_read_bytes(t_k, e_k[0])
                              + env._fourier_table.numel() * 4 + b * 48 + cam_b + b * hw * 7,
                              textured * k * 41 + b * hw * 60)
    return work


def texel_reads(t_tri, attr, t_ent, n_rows=None):
    """(samples whose attributes the epilogue's result reads: a finite
    t_tri that no strictly closer entity beats; of them those with a
    texel to evaluate: slot >= 0, and below ``n_rows`` table rows where
    given)."""
    read = torch.isfinite(t_tri)
    if t_ent is not None:
        read &= ~(t_ent < t_tri)
    slot = torch.round(attr[..., 14].float())
    tex = read & (slot >= 0)
    if n_rows is not None:
        tex &= slot < n_rows
    return int(read.sum()), int(tex.sum())


def random_maze_states(env, gen, seed=7):
    """States from a reset of the 8x8 maze with each agent at a uniform
    point of a uniform cell, 0.5 from its walls, facing a uniform yaw:
    frames show corridors, closed walls, junctions and the box."""
    spec = env.spec
    state, _ = env.reset(seed=seed)
    n = env.num_envs
    u = torch.rand((n, 5), generator=gen).to(env.device)
    pitch = spec.room_size + spec.gap_size
    i = torch.clamp(torch.floor(u[:, 0] * spec.num_rows), max=spec.num_rows - 1)
    j = torch.clamp(torch.floor(u[:, 1] * spec.num_cols), max=spec.num_cols - 1)
    inner = spec.room_size - 1.0
    pos = torch.stack([j * pitch + 0.5 + inner * u[:, 2], torch.zeros_like(u[:, 0]),
                       i * pitch + 0.5 + inner * u[:, 3]], dim=1)
    return state.replace(pos=pos, dir=(u[:, 4] * 2.0 - 1.0) * math.pi)


def phase_maze_kernels(maze, n_mesh_envs=64):
    """The render kernels at the main path's shapes, the 8x8 maze's
    procgen render at B=8192: tri_pass on the paired bank (Sp = 608 rows,
    each env's own maze), the box, the epilogue; each timed. Then the
    paired tri_pass with mesh rows, on ``n_mesh_envs`` of those views
    with 1,000 synthetic mesh rows each around its camera."""
    from miniworld_tpu_torch.render import raycast as rc

    gen = torch.Generator().manual_seed(4321)
    state = random_maze_states(maze, gen)
    cam = rc.camera_grid(state, W, H)
    bank = maze._bank
    tri = (bank.pg_verts9, bank.pg_attr, state.layout_id, cam, maze._all_quads)
    paired = (bank.pg_verts9_alt, bank.pg_attr_alt, maze._pg_wall, state.wall_open)
    ent = ((state.ent_pos, state.ent_size, state.ent_dir, state.ent_height,
            state.ent_color, rc.entity_flags(bank, state)), *maze._shapes_present[:2])
    epi = (maze._atlas, (state.light_pos, state.light_color, state.light_ambient,
                         state.sky_color), maze.fourier_k, maze._fourier_table)
    timings = {}
    errs, outs = run_stage_checks(
        tri, ent, epi, f"maze8x8-procgen B={B_MAZE} HW={W * H} Sp={tri[0].shape[2]} "
        f"paired E=1", timings, paired=paired, plain_iters=1)
    t_k, a_k, e_k = outs
    hit = torch.isfinite(t_k)
    say("maze-scene", px_hit=f"{float(hit.float().mean()):.3f}",
        walls_open=f"{float(state.wall_open.mean()):.3f}",
        rows_alt=f"{float((maze._pg_wall >= 0).float().mean()):.3f}")
    sl = slice(0, n_mesh_envs)
    c = cam_rows(cam, sl)
    rows9, row_attrs = wide_mesh_rows(c, gen)
    shift = torch.zeros_like(rows9)  # around each camera: its x and z
    shift[:, 0::3] = c.origin[:, 0, None, None]
    shift[:, 2::3] = c.origin[:, 2, None, None]
    _, _, err = check_tri_pass(
        (*tri[:2], state.layout_id[sl], c, maze._all_quads),
        f"maze8x8-procgen B={n_mesh_envs} Sp={tri[0].shape[2]} paired "
        f"N={rows9.shape[2]} wide mesh rows", mesh=(rows9 + shift, row_attrs),
        paired=(*paired[:3], state.wall_open[sl]))
    errs["tri_pass"] = max(errs["tri_pass"], err)
    tile = rc.tri_pass_tile()[:2]
    stats = tri_cull_stats(tri, paired, tile)
    say("tri-cull", env=MAZE_ID, B=B_MAZE, **cull_fields(stats, tile, tri[0].shape[2]))
    work = stage_work(maze, state, tri, ent, outs, stats["hit_pairs"], paired=paired)
    sweep = [(f"{MAZE_ID} procgen B={B_MAZE}", lambda: rc.tri_pass(*tri, None, paired),
              (t_k, a_k))]
    return errs, timings, work, sweep


def tie_cameras(dev, n, rng):
    """n W x H cameras 1.5 m up over x in [-0.5, 3], z in [-1, 1],
    facing +x within 0.4 rad (yaw) and 10 degrees (pitch), 60 degrees
    of vertical field of view: the tie cases' views."""
    from miniworld_tpu_torch.ops import geom
    from miniworld_tpu_torch.render import raycast as rc

    f32 = np.float32
    yaw = torch.from_numpy(rng.uniform(-0.4, 0.4, n).astype(f32))
    pitch = torch.from_numpy(rng.uniform(-10.0, 10.0, n).astype(f32))
    fwd, up, right = geom.cam_basis(yaw, pitch)
    origin = np.stack([rng.uniform(-0.5, 3.0, n), np.full(n, 1.5), rng.uniform(-1, 1, n)], 1)
    tan_y = torch.full((n,), math.tan(math.radians(30.0)))
    xbase = 2.0 * (torch.arange(W, dtype=torch.float32) + 0.5) * (1.0 / W) - 1.0
    ybase = 1.0 - 2.0 * (torch.arange(H, dtype=torch.float32) + 0.5) * (1.0 / H)
    return rc.Camera(*(t.to(dev) for t in (torch.from_numpy(origin.astype(f32)), fwd, right,
                                           up, tan_y * (W / H), tan_y, xbase, ybase)))


def tie_case(dev, n=B_STAGE, g=256, seed=21):
    """Synthetic bank of 4 x g prims in front of n cameras (facing +x,
    numpy draws from ``seed``): a group of g random quads and triangles
    (rows 1 and 2 equal: a tie inside a chunk), the group again (at
    tri_chunk g or a divisor of it, the same chunk-local indices in a
    later chunk), the group rolled by 37 rows (other local indices), and
    new prims. Every copy has its own attributes. Returns the tri_pass
    arguments (verts9 (1, 9, 4g), attr, layout_id, cam, all_quads)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    cam = tie_cameras(dev, n, rng)
    v0 = np.stack([rng.uniform(4, 10, g), rng.uniform(0.0, 2.5, g), rng.uniform(-2, 2, g)])
    base = np.concatenate([v0, v0 + rng.uniform(-2, 2, (3, g)), v0 + rng.uniform(-2, 2, (3, g))])
    base[:, 2] = base[:, 1]
    new = base[:, rng.permutation(g)] + rng.uniform(-0.5, 0.5, (9, 1))
    verts9 = np.concatenate([base, base, np.roll(base, 37, axis=1), new], 1)[None].astype(f32)
    attr = rng.uniform(-1, 1, (1, 4 * g, 16)).astype(f32)
    kinds = (rng.uniform(size=g) < 0.5).astype(f32)
    attr[0, :, 15] = np.concatenate([kinds, kinds, np.roll(kinds, 37), kinds])
    return (torch.from_numpy(verts9).to(dev), torch.from_numpy(attr).to(dev),
            torch.zeros(n, dtype=torch.int32, device=dev), cam, False)


def overflow_case(dev, n=256, S=4096, seed=23):
    """A bank of S front-facing triangles 6-10 m ahead of n cameras
    (numpy draws from ``seed``), every one of them inside every view, so
    that all S rows survive the image cull and the multi-chunk kernel scans
    them in several windows: rows 1024-2047 repeat rows 0-1023 with other
    attributes (at tri_chunk 1,024 each pair ties at the same chunk-local
    index in chunks 0 and 1, and lies in two windows), the other rows are
    new. Returns the tri_pass arguments (verts9 (1, 9, S), attr, layout_id,
    cam, all_quads)."""
    from miniworld_tpu_torch.ops import geom
    from miniworld_tpu_torch.render import raycast as rc

    rng = np.random.default_rng(seed)
    f32 = np.float32
    yaw = torch.from_numpy(rng.uniform(-0.05, 0.05, n).astype(f32))
    pitch = torch.from_numpy(rng.uniform(-2.0, 2.0, n).astype(f32))
    fwd, up, right = geom.cam_basis(yaw, pitch)
    origin = np.stack([rng.uniform(-0.5, 0.5, n), np.full(n, 1.5), rng.uniform(-0.2, 0.2, n)], 1)
    tan_y = torch.full((n,), math.tan(math.radians(30.0)))
    xbase = 2.0 * (torch.arange(W, dtype=torch.float32) + 0.5) * (1.0 / W) - 1.0
    ybase = 1.0 - 2.0 * (torch.arange(H, dtype=torch.float32) + 0.5) * (1.0 / H)
    cam = rc.Camera(*(t.to(dev) for t in (torch.from_numpy(origin.astype(f32)), fwd, right, up,
                                           tan_y * (W / H), tan_y, xbase, ybase)))
    v0 = np.stack([rng.uniform(6, 10, S), rng.uniform(1.2, 1.8, S), rng.uniform(-0.6, 0.6, S)])
    e1, e2 = rng.uniform(-1.5, 1.5, (3, S)), rng.uniform(-1.5, 1.5, (3, S))
    e1[0] = e2[0] = 0.0  # upright, facing -x
    back = np.cross(e2, e1, axis=0)[0] < 0  # det = (e2 x e1) . d must be > 0 for d ~ +x
    e1[:, back], e2[:, back] = e2[:, back], e1[:, back].copy()
    verts9 = np.concatenate([v0, v0 + e1, v0 + e2])
    verts9[:, 1024:2048] = verts9[:, :1024]
    attr = rng.uniform(-1, 1, (1, S, 16)).astype(f32)
    attr[0, :, 15] = 1.0
    return (torch.from_numpy(verts9[None].astype(f32)).to(dev), torch.from_numpy(attr).to(dev),
            torch.zeros(n, dtype=torch.int32, device=dev), cam, False)


def phase_chunks(side, side_stage, wall_stage, hall_run):
    """The multi-chunk tri_pass against tri_pass_chunked, exactly: Sidewalk
    views at B=64 in chunks of 1,024 (3), of 496 (6, the bank repadded as
    the JAX package plans it at 160x120, B=1024) and of 16 (192); WallGap
    views at B=64 in chunks of 1,024 (2); the tie case in chunks of 256
    and 16, where the chunk rule decides hundreds of pixels (against the
    global row index of one chunk). Then every render stage at the
    Sidewalk main path's shapes (B=1024, 3 chunks), timed, with tri_pass
    also held exactly there with a synthetic texture-variant override and
    with the float32 carry (the grid of one block an env that is timed);
    the overflow case (overflow_case: every row of S = 4,096 in view, in
    chunks of 1,024 and of 1,000, several windows an env); and a second
    timing of Hallway's single-chunk tri_pass (``hall_run``). Returns
    (errs, timings, work)."""
    from miniworld_tpu_torch import vector as tvector
    from miniworld_tpu_torch.convert import layout_from_numpy
    from miniworld_tpu_torch.render import raycast as rc

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(2468)
    tile = rc.tri_pass_tile()[:2]
    err = 0.0
    lo, hi = (-2.5, 0.5), (5.5, 11.5)  # the sidewalk and the street beside it
    state = spread_states(side_stage, gen, lo, hi)
    cam = rc.camera_grid(state, W, H)
    bank = side_stage._bank
    tri = (bank.tri_verts9, bank.tri_attr, state.layout_id, cam, side_stage._all_quads)
    bank496_np, st = tvector.install_statics(*tvector.build_bank(side_stage.spec), 1024,
                                             160 * 120)
    b496 = layout_from_numpy(bank496_np, dev)
    if (st["tri_chunk"], b496.tri_verts9.shape[2]) != (496, 2976):
        raise AssertionError(f"Sidewalk at 160x120, B=1024 plans {st['plan']}")
    cases = [(tri, 1024, f"{SIDE_ID} B={B_STAGE} S=3072 3 chunks of 1024"),
             ((b496.tri_verts9, b496.tri_attr, *tri[2:]), 496,
              f"{SIDE_ID} B={B_STAGE} S=2976 6 chunks of 496 (the 160x120 plan)"),
             (tri, 16, f"{SIDE_ID} B={B_STAGE} S=3072 192 chunks of 16")]
    w_state = spread_states(wall_stage, gen, (-6.5, -7.5), (6.5, 7.5))
    w_cam = rc.camera_grid(w_state, W, H)
    w_tri = (wall_stage._bank.tri_verts9, wall_stage._bank.tri_attr, w_state.layout_id, w_cam,
             wall_stage._all_quads)
    cases.append((w_tri, 1024, f"{WALL_ID} B={B_STAGE} S=2048 2 chunks of 1024"))
    ties = tie_case(dev)
    for tc in (256, 16):
        cases.append((ties, tc, f"ties B={B_STAGE} S=1024 {1024 // tc} chunks of {tc}"))
    for args, tc, label in cases:
        t_k, a_k, e = check_tri_pass(args, label, tri_chunk=tc)
        err = max(err, e)
        if args is ties:  # pixels where the chunk rule, not the row index, decides
            _, a_one = rc.tri_pass_plain(*args)
            decided = int((a_one != a_k).any(-1).sum())
            say("tie-case", tri_chunk=tc, px_hit=f"{float(torch.isfinite(t_k).float().mean()):.3f}",
                px_decided_by_chunk_rule=decided)
            if decided < 100:
                raise AssertionError(f"the tie case decides only {decided} pixels")
    for label, args in ((SIDE_ID, tri), (WALL_ID, w_tri)):
        stats = tri_cull_stats(args, tile=tile, block=16)
        say("tri-cull", env=label, B=B_STAGE, **cull_fields(stats, tile, args[0].shape[2]))
    # every row in every view: the multi-chunk kernel's windows, a row
    # read by two chunks (tri_chunk 1,000: the last chunk from row 3,096),
    # ties between windows
    ovf = overflow_case(dev)
    survivors = image_survivors(ovf)
    if int(survivors.min()) != ovf[0].shape[2]:
        raise AssertionError(f"the overflow case keeps {int(survivors.min())} rows in a view")
    _, a_first = rc.tri_pass_plain(ovf[0][:, :, :1024], ovf[1][:, :1024], *ovf[2:])
    for tc in (1024, 1000):
        t_k, a_k, e = check_tri_pass(ovf, f"overflow B={ovf[2].shape[0]} S=4096 all in view "
                                     f"chunks of {tc}", tri_chunk=tc)
        err = max(err, e)
        decided = int(((a_k == a_first).all(-1) & torch.isfinite(t_k)).sum())
        say("tie-case", route="overflow", tri_chunk=tc, windows_per_env=windows_all_in_view(4096),
            px_hit=f"{float(torch.isfinite(t_k).float().mean()):.3f}",
            px_won_by_rows_0_1023=decided)
        if tc == 1024 and decided < 100:  # ties at equal local indices, chunks 0 and 1
            raise AssertionError(f"the overflow case decides only {decided} pixels")

    # every render stage at the Sidewalk main path's shapes, timed
    state = spread_states(side, gen, lo, hi)
    s_cam, s_tri, s_ent, s_epi = stage_inputs(side, state)
    timings = {}
    errs, outs = run_stage_checks(
        s_tri, s_ent, s_epi, f"{SIDE_ID} B={side.num_envs} HW={W * H} S=3072 3 chunks "
        f"E={state.ent_pos.shape[1]}", timings, plain_iters=1, tri_chunk=side.tri_chunk)
    errs["tri_pass"] = max(errs["tri_pass"], err)
    stats = tri_cull_stats(s_tri, tile=tile, block=16)
    say("tri-cull", env=SIDE_ID, B=side.num_envs, **cull_fields(stats, tile, 3072))
    work = stage_work(side, state, s_tri, s_ent, outs, stats["hit_pairs"])
    # the timed grid (one block an env at B >= 1024) with the override and
    # the float32 carry
    keys = torch.randint(0, 1 << 32, (side.num_envs,), generator=gen).to(dev)
    override = (keys, spread_tex(torch.zeros((1, 3072, 4), device=dev), gen), None)
    errs["tri_pass"] = max(errs["tri_pass"], check_override(
        s_tri, override, f"{SIDE_ID} B={side.num_envs} S=3072 3 chunks synthetic variants",
        tri_chunk=side.tri_chunk)[0])
    errs["tri_pass"] = max(errs["tri_pass"], check_tri_pass(
        s_tri, f"{SIDE_ID} B={side.num_envs} S=3072 3 chunks", tri_chunk=side.tri_chunk,
        attr_dtype=torch.float32)[2])
    say_window(f"{SIDE_ID} 3 chunks", s_tri)
    ms, plain_ms = timings["tri_pass"]
    say("kernel-time", kernel="tri_pass", instance="multi", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound(*work['tri_pass'])[0]:.4f}",
        bound_full_scan_ms=f"{bound(*work['tri_pass_full_scan'])[0]:.4f}",
        shapes=f"{SIDE_ID} B={side.num_envs} HW={W * H} S=3072 tri_chunk=1024")
    say("kernel-time", kernel="tri_pass", reading="second",
        ms=f"{cuda_ms(hall_run, 50):.4f}", shapes=f"{ENV_ID} B={B} HW={W * H}")
    return errs, timings, work


def start_tile_sweep_builds():
    """tri_pass built with each TILE_SWEEP tile and pixels per thread, one
    nvcc each, all started together in the background (they overlap the
    phases before the sweep): (pool, futures, start time)."""
    from concurrent.futures import ThreadPoolExecutor

    from miniworld_tpu_torch.render import cuda_build

    defines = [(f"-DTILE_W={w}", f"-DTILE_H={h}", f"-DPIX_PER_THREAD={k}")
               for w, h, k in TILE_SWEEP]
    pool = ThreadPoolExecutor(len(defines))
    return pool, [pool.submit(lambda d=d: cuda_build.build(d, ("tri_pass.cu",))[0])
                  for d in defines], time.perf_counter()


def phase_tile_sweep(cases, builds):
    """The ``start_tile_sweep_builds`` builds on each case = (label, run,
    ref): timed over 20 launches of ``run`` after the default build, and
    held equal to the default build's result ``ref``."""
    from miniworld_tpu_torch.render import cuda_build, raycast as rc

    pool, futures, t0 = builds
    libs = [f.result() for f in futures]
    pool.shutdown()
    say("tile-sweep-build", variants=len(libs), seconds_since_start=
        f"{time.perf_counter() - t0:.2f}")

    for label, run, ref in cases:
        default_ms = cuda_ms(run, 20)
        for (w, h, k), lib in zip(TILE_SWEEP, libs):
            with cuda_build.library(lib):
                t, a = run()
                equal = torch.equal(t, ref[0]) and torch.equal(a, ref[1])
                ms = cuda_ms(run, 20)
            say("tile-sweep", tile=f"{w}x{h}", pix_per_thread=k, threads=w * h // k,
                ms=f"{ms:.4f}", default_ms=f"{default_ms:.4f}", equal_to_default=equal,
                shapes=f"{label} HW={W * H}")
            if not equal:
                raise AssertionError(f"tri_pass with tile {w}x{h}/{k} differs from the "
                                     f"default build ({label})")


def phase_mazegen(maze, timings):
    """mazegen kernel vs gen_walls_plain, bit for bit, at B=8192 subseeds of
    the reset's purpose 17 on the main path's 8x8 grid and on 2x2, 3x3
    and 16x16 grids (the kernel's visited-mask instances of 1, 2 and 8
    words), 512 of each grid's mazes checked as spanning trees on the
    host; timed at the main path's shapes (CUDA events, and the kernel
    alone under torch.profiler), and at B=132, one env an SM: the kernel's
    time there is the dependent chain of 2N - 1 steps (chain_ms, profiler).
    Returns (max abs error, work, chain_ms)."""
    from miniworld_tpu_torch.ops import mazegen, rng as rng_ops

    spec = maze.spec
    rows, cols = spec.num_rows, spec.num_cols
    keys = rng_ops.split(rng_ops.key_data(13, maze.device), maze.num_envs)
    seed = rng_ops.sub(rng_ops.cheap_seed(keys), 17)
    err = 0.0
    for g_rows, g_cols in ((2, 2), (3, 3), (rows, cols), (16, 16)):
        k_out = mazegen.gen_walls(seed, g_rows, g_cols)
        p_out = mazegen.gen_walls_plain(seed, g_rows, g_cols)
        n_differ = int((k_out.view(torch.int32) != p_out.view(torch.int32)).any(dim=1).sum())
        sample = k_out[:512].cpu().numpy() > 0.5
        trees = sum(mazegen.maze_is_spanning_tree(w, g_rows, g_cols) for w in sample)
        distinct = len({w.tobytes() for w in sample})
        say("kernel-vs-plain", kernel="mazegen", case=f"B={maze.num_envs} "
            f"grid={g_rows}x{g_cols} W={k_out.shape[1]}", envs_differ=n_differ,
            spanning_trees=f"{trees}/{len(sample)}", distinct=f"{distinct}/{len(sample)}",
            exact=True)
        # the backtracker makes 2 distinct mazes on a 2x2 grid (the paths
        # around the 4-cycle): the main grid's half of the sample, 2 on others
        least = len(sample) // 2 if (g_rows, g_cols) == (rows, cols) else 2
        if n_differ or trees != len(sample) or distinct < least:
            raise AssertionError(f"mazegen {g_rows}x{g_cols}: {n_differ} envs differ from "
                                 f"plain, {len(sample) - trees} of {len(sample)} not spanning "
                                 f"trees, {distinct} distinct")
        err = max(err, float((k_out - p_out).abs().max()))
    timings["mazegen"] = (cuda_ms(lambda: mazegen.gen_walls(seed, rows, cols), 50),
                          cuda_ms(lambda: mazegen.gen_walls_plain(seed, rows, cols), 3),
                          kernel_ms(lambda: mazegen.gen_walls(seed, rows, cols), 50,
                                    "mazegen_kernel"))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    chain_seed = seed[:n_sm].contiguous()
    chain_ms = kernel_ms(lambda: mazegen.gen_walls(chain_seed, rows, cols), 50, "mazegen_kernel")
    n, n_cells, n_walls = maze.num_envs, rows * cols, mazegen.num_walls(rows, cols)
    # per step: 4 neighbour reads and visited tests, the pick, the push
    # or pop, about 25 operations; 2N - 1 steps per env
    work = (n * 4 + n_cells * 4 * 4 * 2 + n * n_walls * 4, n * (2 * n_cells - 1) * 25)
    return err, work, chain_ms


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


_SASS: dict = {}


def sass_term_instructions(k_terms, gain, kernel="pixel_epilogue_ss2"):
    """Instructions a Fourier term takes in the built library's SS=2
    pixel_epilogue instance with the table in shared memory, K =
    ``k_terms`` and GAIN = ``gain``, read from ``cuobjdump -sass``: a term
    makes one paired bf16 conversion (F2FP.BF16...PACK_AB), so the span
    from the instance's first such conversion to its last, over their
    count less one, is the instructions of a term as scheduled. With
    ``kernel="topview_epilogue"``, the top view's instance (the table in
    shared memory, terms without a footprint), whose K terms, unrolled,
    make its first K such conversions (the texel's end rounds its sums
    after them): the span over those. None where cuobjdump or the
    instance is missing."""
    from miniworld_tpu_torch.render import cuda_build

    if "lines" not in _SASS:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        try:
            out = subprocess.run([tool, "-sass", cuda_build.BUILD_INFO["path"]],
                                 capture_output=True, text=True, check=True).stdout
        except (OSError, KeyError, subprocess.CalledProcessError):
            out = ""
        _SASS["lines"] = out.splitlines()
    name = (f"pixel_epilogue_ss2_kernelILb1ELi{k_terms}ELb{int(gain)}ELb0ELb0E"
            if kernel == "pixel_epilogue_ss2"
            else f"topview_epilogue_kernelILb1ELi{k_terms}ELb{int(gain)}ELb0E")
    packs, n, inside = [], 0, False
    for ln in _SASS["lines"]:
        if "Function :" in ln:
            inside = name in ln
            n = 0
            continue
        if inside and ln.strip().startswith("/*") and "*/" in ln and ";" in ln:
            if "F2FP.BF16" in ln and "PACK_AB" in ln:
                packs.append(n)
            n += 1
    if kernel == "topview_epilogue":
        packs = packs[:k_terms]
    if len(packs) < 2:
        return None
    return (packs[-1] - packs[0]) / (len(packs) - 1)


def issue_floor_ms(n_terms, per_term):
    """The least time the card's schedulers take to issue ``n_terms``
    Fourier terms of ``per_term`` instructions each (every SM issues 4
    warp instructions a clock, 128 lanes' worth, at the card's highest SM
    clock from nvidia-smi); None without a SASS count."""
    if per_term is None:
        return None
    if "clock_hz" not in _SASS:
        mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, check=True).stdout.split()[0]
        _SASS["clock_hz"] = float(mhz) * 1e6
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return n_terms * per_term / (n_sm * 128 * _SASS["clock_hz"]) * 1e3


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def ent_read_bytes(t_tri, t_ent):
    """Bytes pixel_epilogue must read of the entity pass's results on
    these inputs: its t at every sample (4), its colour and normal (24)
    only at the samples where the entity is strictly closer and wins."""
    if t_ent is None:
        return 0
    return t_ent.numel() * 4 + int((t_ent < t_tri).sum()) * 24


# ---------------------------------------------------------------------------
# the placement kernel


def capture_place(name, run):
    """(args, kwargs) of the call of ``ops.place.<name>`` that ``run()``
    makes: ``place_all`` in a reset, ``place_one`` in CollectHealth's step."""
    from miniworld_tpu_torch.ops import place as place_ops

    captured = {}
    orig = getattr(place_ops, name)

    def capture(*args, **kwargs):
        captured["args"], captured["kwargs"] = args, kwargs
        return orig(*args, **kwargs)

    setattr(place_ops, name, capture)
    try:
        run()
    finally:
        setattr(place_ops, name, orig)
    return captured["args"], captured["kwargs"]


def capture_place_args(env, seed):
    """The inputs a reset gives ``place_all``."""
    return capture_place("place_all", lambda: env.reset(seed=seed))


def place_work(args, kwargs, first):
    """{"place": (bytes, float operations) of the place kernel on these
    inputs, counting the work its outputs depend on; "place_all_tries":
    the same bytes with every try of the reference's work (budget + 1
    tries a slot, each drawing its room over the full CDF, 3R)}.

    The needed work: each env's room CDF once (R multiply-adds), a room
    draw by bisection (2 ceil(log2(R + 1)) operations) where the rule
    does not fix the room, and for each live slot its tries up to its
    first pass (``first``, from ``_place_all_plain`` on the same inputs),
    or, where all failed, every try, the fallback candidate, the
    fallback room's draw and the clamp. Per try: bbox and position 10,
    outline 4V, walls 22 per segment, entities 8 per slot placed before
    it; direction 3 per slot."""
    seeds, bank, _, rules, radius, slot_mask = args
    n, E = slot_mask.shape
    R = bank.room_mask.shape[1]
    V, ns = bank.room_outline.shape[2], bank.room_segs.shape[3]
    budget = kwargs["budget"]
    procgen = [kwargs["room_weight"], *kwargs["seg_gate"]] if kwargs["seg_gate"] else []
    room_bytes = sum(t.numel() * t.element_size() for t in [
        bank.room_mask, bank.room_area, bank.room_aabb, bank.room_outline,
        bank.room_norms, bank.room_vmask, bank.room_segs, *procgen])
    nbytes = n * (E + 1) * 44 + n * 4 + n * E + room_bytes + n * (4 * E + 4) * 4
    all_tries = n * (E + 1) * (budget + 1) * (3 * R + 10 + 4 * V + 22 * ns + 8 * E)

    mask = slot_mask.long()
    live = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=1)  # (n, E+1)
    before = torch.cat([torch.cumsum(mask, 1) - mask, mask.sum(1, keepdim=True)], dim=1)
    draws = (rules["rule_room"] < 0).long() * live
    draw_ops = draws * 2 * math.ceil(math.log2(R + 1))
    per_try = draw_ops + 10 + 4 * V + 22 * ns + 8 * before
    found = first < budget
    tries = torch.where(found, first + 1, torch.full_like(first, budget))
    fallback = torch.where(found, torch.zeros_like(first), 2 * draw_ops + 10 + 8)
    needed = (live * (tries * per_try + fallback + 3)).sum() + 2 * R * int(
        draws.any(1).sum())
    return {"place": (nbytes, int(needed)), "place_all_tries": (nbytes, all_tries)}


def live_slot_tries(slot_mask, first, budget):
    """The mean number of tries a live slot makes up to its first pass
    (``budget`` where all fail), over the valid slots and the agent."""
    live = torch.cat([slot_mask, torch.ones_like(slot_mask[:, :1])], dim=1)
    return float(torch.clamp(first + 1, max=budget)[live].float().mean())


def check_place(label, args, kwargs):
    """place kernel vs place_all_plain: positions and directions equal,
    env for env; returns (the max abs difference (0), each slot's first
    passing try (B, E+1) in the plain version)."""
    from miniworld_tpu_torch.ops import place as place_ops

    k_out = place_ops.place_all(*args, **kwargs)
    *p_out, first = place_ops._place_all_plain(*args, **kwargs)
    n = args[0].shape[0]
    differ = torch.zeros(n, dtype=torch.bool, device=args[0].device)
    err = 0.0
    for a, b in zip(k_out, p_out):
        differ |= (a != b).reshape(n, -1).any(dim=1)
        err = max(err, float((a - b).abs().max()))
    say("kernel-vs-plain", kernel="place", case=f"{label} B={n} E+1={args[4].shape[1]} "
        f"R={args[1].room_mask.shape[1]} budget={kwargs['budget']}",
        envs_differ=int(differ.sum()), max_abs_err=f"{err:.3e}",
        envs_exhausting_a_slot=f"{float((first == kwargs['budget']).any(1).float().mean()):.3f}")
    if bool(differ.any()):
        raise AssertionError(f"place ({label}): {int(differ.sum())} envs differ")
    return err, first


def phase_place(pick, four, maze, room, timings, pick_timings, work, pick_work):
    """place kernel vs place_all_plain from real reset inputs: positions
    and directions must be equal, env for env — PickupObjects (18
    entity slots), FourRooms, RoomObjects (its budget of 48, agent radius
    1.5: tries over two rounds of lanes), and the 8x8 maze with each env's
    maze as room weights and gated walls; then the maze's inputs with the
    radii scaled until at least half the envs exhaust a slot's budget;
    both with budgets 0 (the fallback alone), 30 (budget + 2 = 32 lanes,
    one round), 31 (the fallback room in lane 0 of a second round), 40 and
    48 (the tries over two rounds of the kernel's 32 lanes). The kernel is
    timed at the maze's (``timings``) and PickupObjects'
    (``pick_timings``) shapes, and their place_work goes into ``work``
    and ``pick_work``; returns the max abs error."""
    from miniworld_tpu_torch.ops import place as place_ops

    errs = 0.0
    for env, seed, tm, wk in ((pick, 11, pick_timings, pick_work), (four, 12, None, None),
                              (room, 14, None, None), (maze, 13, timings, work)):
        args, kwargs = capture_place_args(env, seed)
        if env is room and kwargs["budget"] != 48:
            raise AssertionError(f"RoomObjects placed at budget {kwargs['budget']}")
        err, first = check_place(env.spec.gym_id, args, kwargs)
        errs = max(errs, err)
        if env is maze and kwargs["seg_gate"] is None:
            raise AssertionError("the maze's reset placed without its maze")
        if tm is not None:
            tm["place"] = (cuda_ms(lambda: place_ops.place_all(*args, **kwargs), 50),
                           cuda_ms(lambda: place_ops.place_all_plain(*args, **kwargs), 5))
            dev_ms = kernel_ms(lambda: place_ops.place_all(*args, **kwargs), 50, "place_kernel")
            DEVICE_MS[("place", env.spec.gym_id)] = dev_ms
            say("kernel-device-time", kernel="place", env=env.spec.gym_id,
                B=env.num_envs, device_ms=f"{dev_ms:.4f}" if dev_ms else "not measured",
                events_ms=f"{tm['place'][0]:.4f}",
                tries_per_live_slot=f"{live_slot_tries(args[5], first, kwargs['budget']):.3f}")
            wk.update(place_work(args, kwargs, first))

    # the maze's inputs (args, kwargs of the last reset above), harder
    seeds, bank, layout_id, rules, radius, slot_mask = args
    for scale in (2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0):
        big = (seeds, bank, layout_id, rules, radius * scale, slot_mask)
        first = place_ops._place_all_plain(*big, **kwargs)[4]
        exhausted = float((first == kwargs["budget"]).any(1).float().mean())
        if exhausted >= 0.5:
            break
    say("place-exhausted", env=maze.spec.gym_id, radius_scale=scale,
        envs_exhausting_a_slot=f"{exhausted:.3f}")
    if exhausted < 0.5:
        raise AssertionError(f"place: only {exhausted:.3f} of the envs exhaust a budget")
    errs = max(errs, check_place(f"{maze.spec.gym_id} radius x{scale}", big, kwargs)[0])
    for label, a in (("", args), (f" radius x{scale}", big)):
        for budget in (0, 30, 31, 40, 48):
            errs = max(errs, check_place(f"{maze.spec.gym_id}{label} lane rounds", a,
                                         {**kwargs, "budget": budget})[0])
    return errs


# ---------------------------------------------------------------------------
# domain randomisation's texture-variant override and the supersample=2
# epilogue


def widen_cameras(state, gen):
    """The states with each env's camera spread further than domain
    randomisation draws it: fov 45-75 degrees, pitch -20 to 20, height
    1.2-1.8, so that a kernel reading one env's camera for another, or a
    cull margin that assumes one fov, shows."""
    n = state.pos.shape[0]
    u = torch.rand((n, 3), generator=gen).to(state.pos.device)
    return state.replace(cam_fov_y=45.0 + 30.0 * u[:, 0], cam_pitch=-20.0 + 40.0 * u[:, 1],
                         cam_height=1.2 + 0.6 * u[:, 2])


def spread_tex(tex, gen, n_atlas=64):
    """A synthetic table of the same rows as ``tex`` (slot id, atlas base,
    variant count, 0): ids up to 2^20, bases -1 on a tenth of the rows,
    counts 1-6, so that every route's rows take several variants (the
    real banks of the Maze and PickupObjects have none)."""
    if tex is None:
        return None
    shape = tex.shape[:-1]
    ids = torch.randint(0, 1 << 20, shape, generator=gen).float()
    base = torch.randint(0, n_atlas, shape, generator=gen).float()
    base = torch.where(torch.rand(shape, generator=gen) < 0.1, torch.full_like(base, -1.0), base)
    cnt = torch.randint(1, 7, shape, generator=gen).float()
    return torch.stack([ids, base, cnt, torch.zeros_like(ids)], dim=-1).to(tex.device)


def check_override(tri_args, override, case, mesh=None, paired=None, tri_chunk=None,
                   attr_dtype=torch.bfloat16, active=None):
    """tri_pass with the override against its plain version (0 differing
    pixels in t and all 16 attributes), and against the same launch
    without it: t and every attribute but the slot column equal (the
    override never moves a winner); ``attr_dtype`` and ``active`` as
    check_tri_pass's. Returns (max abs t error, share of the hit pixels
    whose slot the override changed)."""
    from miniworld_tpu_torch.render import raycast as rc

    t_k, a_k, err = check_tri_pass(tri_args, case, mesh, paired, tri_chunk, override,
                                   attr_dtype, active)
    t_n, a_n = rc.tri_pass(*tri_args, mesh, paired, tri_chunk, None, attr_dtype, active)
    if not (torch.equal(t_k, t_n) and torch.equal(a_k[..., :14], a_n[..., :14])
            and torch.equal(a_k[..., 15], a_n[..., 15])):
        raise AssertionError(f"tri_pass override ({case}): winners or t differ from the "
                             "launch without the key")
    hit = torch.isfinite(t_k)
    changed = float((a_k[..., 14] != a_n[..., 14])[hit].float().mean()) if bool(hit.any()) else 0.0
    say("override-vs-unkeyed", case=case, t_equal=True, other_attrs_equal=True,
        hit_px_slot_changed=f"{changed:.3f}")
    return err, changed


def dr_route(env, state):
    """(tri_args, mesh, paired, tri_chunk, override) of the env's render
    of ``state``: its static_rows, mesh rows and the override from its
    slot table, as render_rgbd passes them to tri_pass."""
    from miniworld_tpu_torch.render import raycast as rc

    cam = rc.camera_grid(state, W, H)
    rows, paired = rc.static_rows(env._bank, state, cam, env._pg_wall, env.plan)
    mesh = rc.entity_mesh_rows(env._bank, state)[:2] if env._shapes_present[2] else None
    override = (state.tri_slots, *env._slot_tex)
    return (*rows, cam, env._all_quads), mesh, paired, env.tri_chunk, override


def phase_dr_stages(routes):
    """[dr-stages]: tri_pass with the texture-variant override against
    its plain version on every route, with each env's camera spread
    (widen_cameras), once with the bank's own variant table and once
    with a synthetic one (spread_tex); ``routes`` = [(label, env,
    timed)]. The timed routes time the override launch beside the same
    launch without the key, and the plain version. Returns (max abs t
    error, {label: timings}, {label: work})."""
    from miniworld_tpu_torch.render import raycast as rc

    gen = torch.Generator().manual_seed(97)
    err, timings, work = 0.0, {}, {}
    for label, env, timed in routes:
        tri, mesh, paired, tc, override = dr_route(env, view_states(env, gen, seed=5))
        case = (f"{label} B={env.num_envs} HW={W * H} S={tri[0].shape[2]} tri_chunk={tc} "
                f"plan={env.plan['kind']}{' mesh' if mesh else ''}{' paired' if paired else ''}")
        e, _ = check_override(tri, override, case + " bank variants", mesh, paired, tc)
        err = max(err, e)
        synth = (override[0], spread_tex(override[1], gen), spread_tex(override[2], gen))
        e, changed_s = check_override(tri, synth, case + " synthetic variants", mesh, paired, tc)
        err = max(err, e)
        if changed_s < 0.2:
            raise AssertionError(f"{case}: the synthetic variants change only {changed_s:.3f} "
                                 "of the slots")
        if timed:
            timings[label] = {
                "override": (cuda_ms(lambda: rc.tri_pass(*tri, mesh, paired, tc, override), 50),
                             cuda_ms(lambda: plain_tri_pass(tri, mesh, paired, tc, override), 1,
                                     PLAIN_WARMUP)),
                "unkeyed": (cuda_ms(lambda: rc.tri_pass(*tri, mesh, paired, tc), 50), None),
            }
            stats = tri_cull_stats(tri, paired, block=64)
            work[label] = tri_work(tri, stats["hit_pairs"], paired, override)
            unkeyed_work = tri_work(tri, stats["hit_pairs"], paired)
            say("kernel-time", kernel="tri_pass", instance="override",
                ms=f"{timings[label]['override'][0]:.4f}",
                plain_ms=f"{timings[label]['override'][1]:.4f}",
                ms_without_override=f"{timings[label]['unkeyed'][0]:.4f}",
                bound_ms=f"{bound(*work[label])[0]:.4f}", bound_by=bound(*work[label])[1],
                bound_without_override_ms=f"{bound(*unkeyed_work)[0]:.4f}",
                shapes=case)
    return err, timings, work


def tri_work(tri, hit_pairs, paired=None, override=None, attr_bytes=32, mesh=None):
    """(bytes, operations) of a tri_pass launch on these inputs (at the
    camera's samples), as stage_work counts them, each row tested once
    (of a (B, n) schedule, the distinct chunk rows it names, each read
    once);
    ``override`` adds its table and
    keys (each read once) and 20 operations per pixel (the hash, the
    floor, the clamp and the add); ``attr_bytes``: the winner's row as
    stored, 32 in bf16, 64 with the float32 carry; ``mesh`` = (rows9,
    mesh_hits) adds the mesh rows (read once) and 20 operations per
    (mesh row, pixel) pair that passes the hit test."""
    verts9, _, layout_id, cam, _ = tri
    L, _, S = verts9.shape
    if layout_id.dim() == 2:  # a schedule: the distinct chunk rows it reads
        L = torch.unique(layout_id).numel()
    b, hw = layout_id.shape[0], cam.width * cam.height
    nbytes = (L * S * (9 + 16) * 4 + layout_id.numel() * 4 + b * 14 * 4
              + (cam.width + cam.height) * 4 + b * hw * (4 + attr_bytes))
    if paired is not None:
        nbytes += sum(t.numel() * t.element_size() for t in paired)
    ops = hit_pairs * 22 + b * hw
    if override is not None:
        nbytes += b * 4 + sum(t.numel() * 4 for t in override[1:] if t is not None)
        ops += b * hw * 20
    if mesh is not None:
        nbytes += mesh[0].numel() // 9 * (9 + 16) * 4
        ops += mesh[1] * 20
    return nbytes, ops


def ss_stage_inputs(env, state):
    """The SS=2 epilogue's inputs for the env's render of ``state``: the
    kernels' tri_pass and entity_pass results on the 2W x 2H samples."""
    from miniworld_tpu_torch.render import raycast as rc

    cam = rc.camera_grid(state, 2 * W, 2 * H)
    rows, paired = rc.static_rows(env._bank, state, cam, env._pg_wall, env.plan)
    mesh = rc.entity_mesh_rows(env._bank, state)[:2] if env._shapes_present[2] else None
    t_tri, attr = rc.tri_pass(*rows, cam, env._all_quads, mesh, paired, env.tri_chunk)
    ent = (None,) * 3
    if env._shapes_present[0] or env._shapes_present[1]:
        ent = rc.entity_pass(state.ent_pos, state.ent_size, state.ent_dir, state.ent_height,
                             state.ent_color, rc.entity_flags(env._bank, state), cam,
                             *env._shapes_present[:2])
    lights = (state.light_pos, state.light_color, state.light_ambient, state.sky_color)
    return (t_tri, attr, *ent, env._atlas, cam, *lights, env.fourier_k)


def phase_ss_epilogue(envs):
    """[ss-epilogue]: the SS=2 pixel_epilogue against pixel_epilogue_plain
    with ss=2 on each env's 2x2 samples (0 differing u8 values, equal
    depth), timed with its plain version, beside its bound and the issue
    rate's floor for its Fourier terms (issue_floor_ms); ``envs`` =
    [(label, env)] at their main paths' shapes. Returns ({label: (ms,
    plain ms)}, {label: work}, the max abs u8 difference, {label: floor
    ms})."""
    from miniworld_tpu_torch.render import raycast as rc

    gen = torch.Generator().manual_seed(99)
    timings, work, rgb_err, floors = {}, {}, 0.0, {}
    for label, env in envs:
        if env.spec.gym_id == PICK_ID:
            state = facing_states(env, gen, (0.5, 0.5), (11.5, 11.5))
        else:
            state = spread_states(env, gen, (-0.5, -1.5), (10.5, 1.5))
        args = ss_stage_inputs(env, state)
        table = env._fourier_table
        rgb_k, d_k = rc.pixel_epilogue(*args, table=table, ss=2)
        rgb_p, d_p = rc.pixel_epilogue_plain(*args, ss=2)
        diff = (rgb_k.int() - rgb_p.int()).abs()
        n_rgb = int((diff.amax(-1) > 0).sum())
        rgb_err = max(rgb_err, float(diff.max()))
        n_depth = int((d_k != d_p).sum())
        say("kernel-vs-plain", kernel="pixel_epilogue", instance="SS=2",
            case=f"{label} B={env.num_envs} out={W}x{H} samples={2 * W}x{2 * H}",
            rgb_differs_px=n_rgb, depth_differs_px=n_depth, exact=True)
        if n_rgb or n_depth or rgb_k.shape != (env.num_envs, H, W, 3):
            raise AssertionError(f"pixel_epilogue SS=2 ({label}): kernel differs from plain on "
                                 f"{n_rgb} RGB and {n_depth} depth pixels")
        timings[label] = (cuda_ms(lambda: rc.pixel_epilogue(*args, table=table, ss=2), 50),
                          cuda_ms(lambda: rc.pixel_epilogue_plain(*args, ss=2), 1, PLAIN_WARMUP))
        work[label] = epi_work(args, table, env.fourier_k, 2)
        terms = texel_reads(args[0], args[1], args[2], table.shape[0])[1] * env.fourier_k
        floors[label] = issue_floor_ms(terms, sass_term_instructions(env.fourier_k, False))
        say("kernel-time", kernel="pixel_epilogue", instance="SS=2",
            ms=f"{timings[label][0]:.4f}", plain_ms=f"{timings[label][1]:.4f}",
            bound_ms=f"{bound(*work[label])[0]:.4f}", bound_by=bound(*work[label])[1],
            issue_floor_ms=fmt_ms(floors[label]),
            instructions_a_term=sass_term_instructions(env.fourier_k, False),
            shapes=f"{label} B={env.num_envs} out={W}x{H} samples={2 * W}x{2 * H}")
    return timings, work, rgb_err, floors


def phase_ent_undefined(cases):
    """[ent-undefined]: every pixel_epilogue instance run on the kernels'
    hits twice, with entity_pass's colour and normal NaN wherever its t is
    inf and with zeros there (the plain version's), and once as the kernel
    left them: the three results equal on every pixel, so no consumer
    reads the part the kernel leaves undefined. ``cases`` = [(label, env,
    state, has_gain)], each at its env's supersample and texture mode."""
    from miniworld_tpu_torch.render import raycast as rc

    for label, env, state, gain in cases:
        ss, nearest = env.supersample, env.tex_mode == "nearest"
        cam = rc.camera_grid(state, W * ss, H * ss)
        rows, paired = rc.static_rows(env._bank, state, cam, env._pg_wall, env.plan)
        mesh = (rc.entity_mesh_rows(env._bank, state, fourier=not nearest)[:2]
                if env._shapes_present[2] else None)
        carry = rc.attr_carry_dtype(state.tex_map.shape[1]) if nearest else torch.bfloat16
        t_tri, attr = rc.tri_pass(*rows, cam, env._all_quads, mesh, paired, env.tri_chunk,
                                  None, carry)
        t_ent, col, nrm = rc.entity_pass(
            state.ent_pos, state.ent_size, state.ent_dir, state.ent_height, state.ent_color,
            rc.entity_flags(env._bank, state), cam, *env._shapes_present[:2])
        miss = torch.isinf(t_ent)[..., None]
        kw = {"tex_map": state.tex_map} if nearest else {"table": env._fourier_table}
        rest = (env._atlas, cam, state.light_pos, state.light_color, state.light_ambient,
                state.sky_color, env.fourier_k, gain)
        outs = [rc.pixel_epilogue(t_tri, attr, t_ent, c, n, *rest, ss=ss, **kw)
                for c, n in ((col, nrm),
                             *((torch.where(miss, fill, col), torch.where(miss, fill, nrm))
                               for fill in (torch.tensor(math.nan, device=col.device),
                                            torch.zeros((), device=col.device))))]
        (rgb_k, d_k), (rgb_n, d_n), (rgb_z, d_z) = outs
        differ = [int(((a != b).any(-1) if a.dtype == torch.uint8 else (a != b)).sum())
                  for a, b in ((rgb_n, rgb_z), (d_n.view(torch.int32), d_z.view(torch.int32)),
                               (rgb_k, rgb_z), (d_k.view(torch.int32), d_z.view(torch.int32)))]
        ent_wins = int((t_ent < t_tri).sum())
        instance = (f"{'NEAREST' if nearest else 'GAIN' if gain else 'fourier'} SS={ss}")
        say("ent-undefined", instance=instance, case=f"{label} B={env.num_envs} "
            f"samples={W * ss}x{H * ss}", entity_misses=int(miss.sum()),
            entity_wins=ent_wins, rgb_differs_px=differ[0], depth_differs_px=differ[1],
            as_left_rgb_differs_px=differ[2], as_left_depth_differs_px=differ[3])
        if any(differ) or not ent_wins or not bool(miss.any()):
            raise AssertionError(f"pixel_epilogue {instance} ({label}): {differ} pixels differ "
                                 f"with NaN at the entity's misses ({ent_wins} entity wins)")


def epi_work(args, table, k_terms, ss, glyph_px=0, attr_bytes=32):
    """(bytes, operations) of a pixel_epilogue launch on ``args`` (its
    plain version's positional arguments up to k_terms) with SS = ``ss``:
    each sample's t read once, its bf16 attributes where the result reads
    them (texel_reads), of the entity pass's results what ent_read_bytes
    counts, the table, lights and camera once, 7 bytes out a pixel;
    41 operations per Fourier term of each sample whose texel the result
    reads (texel_reads: a finite t_tri, a slot in the table, no closer
    entity), 60 per
    sample for uv, lighting and the pack, 4 per output pixel for the
    box filter, and 12 per glyph sample (``glyph_px``: the edge width,
    the threshold and the blend). ``attr_bytes``: an attribute row as
    read, 32 in bf16, 64 with the float32 carry."""
    t_tri, attr, t_ent, cam = args[0], args[1], args[2], args[6]
    b, hws = t_tri.shape
    n_out = hws // (ss * ss)
    read, textured = texel_reads(t_tri, attr, t_ent, table.shape[0])
    in_bytes = b * hws * 4 + read * attr_bytes + ent_read_bytes(t_tri, t_ent)
    return (in_bytes + table.numel() * 4 + b * 48 + b * 14 * 4
            + (cam.width + cam.height) * 4 + b * n_out * 7,
            textured * k_terms * 41 + b * hws * 60 + (b * n_out * 4 if ss > 1 else 0)
            + glyph_px * 12)


def phase_dr_ss_paths(maze_dr, four_dr, hall_ss, pick_ss, make_env, rates):
    """The four new main paths at published widths: Maze 8x8 procgen at
    B=8192 and FourRooms at B=1024 with domain randomisation, Hallway at
    B=1024 and PickupObjects at B=4096 with supersample=2, each with its
    breakdown and profile; then kernel-vs-plain rollouts at B_PLAIN,
    exact: FourRooms and MazeS3 procgen (10-step episodes) with domain
    randomisation, Hallway with supersample=2. Returns {label:
    launches}."""
    base = ("tri_pass", "entity_pass", "pixel_epilogue", "place")
    paths = ((maze_dr, "dr", MAZE_KERNELS + ("tri_pass_override",)),
             (four_dr, "dr", base + ("tri_pass_override",)),
             (hall_ss, "ss2", base + ("pixel_epilogue_ss2",)),
             (pick_ss, "ss2", base + ("entity_mesh_pass", "pixel_epilogue_ss2")))
    launches = {}
    for env, tag, kernels in paths:
        label = f"{env.spec.name.lower()}_{tag}_b{env.num_envs}"
        rate, outs, obs, lc, _ = rollouts(env, tag, HORIZON, TRIALS)
        check_rollout(env, outs, obs, lc, HORIZON, TRIALS, kernels)
        rates[label] = (rate, None)
        launches[env.spec.gym_id, tag] = lc
        phase_breakdown(env, render_iters=5, plain_render_iters=0)
    from miniworld_tpu_torch import MiniWorldVec, make_spec

    maze_s3 = MiniWorldVec(make_spec(MAZE_S3_ID, max_episode_steps=MAZE_S3_STEPS), B_PLAIN,
                           obs_width=W, obs_height=H, device=DEVICE, domain_rand=True)
    for env, kernels in ((make_env("MiniWorld-FourRooms-v0", B_PLAIN, domain_rand=True),
                          base + ("tri_pass_override",)),
                         (maze_s3, MAZE_KERNELS + ("tri_pass_override",)),
                         (make_env(ENV_ID, B_PLAIN, supersample=2),
                          base + ("pixel_epilogue_ss2",))):
        tag = "dr" if env.domain_rand else "ss2"
        rate, plain_rate, _, _ = kernel_and_plain(env, PLAIN_HORIZON, TRIALS, kernels, exact=True)
        rates[f"{env.spec.name.lower()}_{tag}_b{B_PLAIN}"] = (rate, plain_rate)
    return launches


# ---------------------------------------------------------------------------
# Sign's glyph epilogue and the paired scan over a clamped second chunk


def sign_states(env, gen, share=0.6, seed=7):
    """States from a reset of Sign with the first ``share`` of the envs
    1-4 m in front of the sign (at x = 10, z = 10.25, facing -x) and
    facing it within 0.35 rad, so their frames show its glyphs; the
    others where they reset."""
    state, _ = env.reset(seed=seed)
    n = env.num_envs
    m = int(n * share)
    u = torch.rand((m, 3), generator=gen).to(env.device)
    pos = state.pos.clone()
    pos[:m, 0] = 6.3 + 2.7 * u[:, 0]
    pos[:m, 2] = 9.3 + 1.9 * u[:, 1]
    yaw = state.dir.clone()
    yaw[:m] = (u[:, 2] * 2.0 - 1.0) * 0.35
    return state.replace(pos=pos, dir=yaw)


def glyph_px(args, table):
    """Samples whose tri_pass winner is a glyph row (bf16 gain < 0 in the
    table) and that no nearer analytic entity covers."""
    t_tri, attr, t_ent = args[0], args[1], args[2]
    slot = torch.round(attr[..., 14].float()).long()
    inside = (slot >= 0) & (slot < table.shape[0])
    glyph = inside & (table[slot.clamp(0, table.shape[0] - 1), 3] < 0.0) & torch.isfinite(t_tri)
    if t_ent is not None:
        glyph &= ~(t_ent < t_tri)
    return int(glyph.sum())


def phase_gain_epilogue(sign):
    """[gain-epilogue]: the GAIN pixel_epilogue against pixel_epilogue_plain
    with has_gain on Sign's render at the main path's shapes (B=1024,
    80x60, K=64), its cameras facing the sign, at SS=1 and SS=2 (the hit
    passes on 160x120 samples): 0 differing u8 values, equal depth, and
    the glyph samples counted; each timed with its plain version.
    Returns ({ss: (ms, plain ms)}, {ss: work}, {ss: glyph samples}, the
    max abs u8 difference)."""
    from miniworld_tpu_torch.render import raycast as rc

    gen = torch.Generator().manual_seed(64)
    state = sign_states(sign, gen)
    table = sign._fourier_table
    timings, work, glyphs, rgb_err = {}, {}, {}, 0.0
    for ss in (1, 2):
        cam = rc.camera_grid(state, W * ss, H * ss)
        rows, paired = rc.static_rows(sign._bank, state, cam)
        mesh = rc.entity_mesh_rows(sign._bank, state)[:2]
        t_tri, attr = rc.tri_pass(*rows, cam, sign._all_quads, mesh, paired, sign.tri_chunk)
        ent = (None,) * 3  # Sign's boxes and keys are all mesh rows
        if sign._shapes_present[0] or sign._shapes_present[1]:
            ent = rc.entity_pass(state.ent_pos, state.ent_size, state.ent_dir,
                                 state.ent_height, state.ent_color,
                                 rc.entity_flags(sign._bank, state), cam,
                                 *sign._shapes_present[:2])
        args = (t_tri, attr, *ent, sign._atlas, cam, state.light_pos, state.light_color,
                state.light_ambient, state.sky_color, sign.fourier_k)
        rgb_k, d_k = rc.pixel_epilogue(*args, True, table=table, ss=ss)
        rgb_p, d_p = rc.pixel_epilogue_plain(*args, True, ss=ss)
        diff = (rgb_k.int() - rgb_p.int()).abs()
        n_rgb = int((diff.amax(-1) > 0).sum())
        n_depth = int((d_k != d_p).sum())
        rgb_err = max(rgb_err, float(diff.max()))
        glyphs[ss] = glyph_px(args, table)
        case = (f"{SIGN_ID} B={sign.num_envs} out={W}x{H} samples={W * ss}x{H * ss} "
                f"K={sign.fourier_k} A={table.shape[0]}")
        say("kernel-vs-plain", kernel="pixel_epilogue", instance=f"GAIN SS={ss}", case=case,
            glyph_samples=glyphs[ss], rgb_differs_px=n_rgb, depth_differs_px=n_depth,
            exact=True)
        if n_rgb or n_depth or rgb_k.shape != (sign.num_envs, H, W, 3):
            raise AssertionError(f"pixel_epilogue GAIN SS={ss}: kernel differs from plain on "
                                 f"{n_rgb} RGB and {n_depth} depth pixels")
        if glyphs[ss] < 0.01 * t_tri.numel():
            raise AssertionError(f"only {glyphs[ss]} glyph samples on Sign's frames")
        timings[ss] = (cuda_ms(lambda: rc.pixel_epilogue(*args, True, table=table, ss=ss), 50),
                       cuda_ms(lambda: rc.pixel_epilogue_plain(*args, True, ss=ss), 1,
                               PLAIN_WARMUP))
        work[ss] = epi_work(args, table, sign.fourier_k, ss, glyphs[ss])
        extra = {}
        if ss == 2:  # the SS=2 instance's unrolled K = 64 terms
            per_term = sass_term_instructions(sign.fourier_k, True)
            floor = issue_floor_ms(texel_reads(args[0], args[1], args[2], table.shape[0])[1]
                                   * sign.fourier_k, per_term)
            extra = {"issue_floor_ms": fmt_ms(floor), "instructions_a_term": per_term}
            work["floor"] = floor
        say("kernel-time", kernel="pixel_epilogue", instance=f"GAIN SS={ss}",
            ms=f"{timings[ss][0]:.4f}", plain_ms=f"{timings[ss][1]:.4f}",
            bound_ms=f"{bound(*work[ss])[0]:.4f}", bound_by=bound(*work[ss])[1], **extra,
            table_bytes=table.numel() * 4, shapes=case)
    return timings, work, glyphs, rgb_err


def paired_tie_case(dev, n=B_STAGE, g=48, seed=31):
    """A paired bank of Sp = 608 rows in front of n cameras (tie_cameras):
    a group of g random quads and triangles (rows 1 and 2 equal) at rows
    40-87 (read by chunk 0 only), again at 90-137 (across row 112) and
    300-347 (read by both chunks of 496), rolled by 7 at 540-587 (chunk 1
    only), new prims at 400-447; half the rows on one of 6 walls whose
    closed variant is the same prim with other attributes, each env's
    walls open at random. Returns (tri_pass arguments, paired)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    cam = tie_cameras(dev, n, rng)
    sp = 608
    v0 = np.stack([rng.uniform(4, 10, g), rng.uniform(0.0, 2.5, g), rng.uniform(-2, 2, g)])
    base = np.concatenate([v0, v0 + rng.uniform(-2, 2, (3, g)), v0 + rng.uniform(-2, 2, (3, g))])
    base[:, 2] = base[:, 1]
    kinds = (rng.uniform(size=g) < 0.5).astype(f32)
    verts9 = np.zeros((1, 9, sp), f32)
    kind = np.zeros(sp, f32)
    for start, roll in ((40, 0), (90, 0), (300, 0), (540, 7)):
        verts9[0, :, start:start + g] = np.roll(base, roll, axis=1)
        kind[start:start + g] = np.roll(kinds, roll)
    verts9[0, :, 400:400 + g] = base[:, rng.permutation(g)] + rng.uniform(-0.5, 0.5, (9, 1))
    kind[400:400 + g] = kinds
    attr = rng.uniform(-1, 1, (1, sp, 16)).astype(f32)
    attr_alt = rng.uniform(-1, 1, (1, sp, 16)).astype(f32)
    attr[0, :, 15] = attr_alt[0, :, 15] = kind
    pg_wall = np.where(rng.uniform(size=(1, sp)) < 0.5, rng.integers(0, 6, (1, sp)), -1)
    wall_open = (rng.uniform(size=(n, 6)) < 0.5).astype(f32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    tri = (t(verts9), t(attr), torch.zeros(n, dtype=torch.int32, device=dev), cam, False)
    return tri, (t(verts9), t(attr_alt), t(pg_wall.astype(np.int32)), t(wall_open))


def phase_paired_chunks(maze_ss):
    """[paired-chunks]: the paired tri_pass over 2 chunks of 496, the
    second clamped to rows 112-607 (the 8x8 procgen Maze at
    supersample=2, B >= 1024), against tri_pass_chunked, exactly: on 1024
    of the main path's views (160x120 samples, each env its own maze),
    without and with a synthetic texture-variant override (checked as in
    [dr-stages]), and on the paired tie bank, where the chunk rule
    decides hundreds of pixels, and with the float32 carry. Then timed at
    the main path's shapes (B=8192, 160x120 samples), and the path's other
    stages there (maze_ss_stages). Returns (max abs t error, (ms, plain
    ms), work, maze_ss_stages' dict)."""
    from miniworld_tpu_torch.render import raycast as rc

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(608)
    tc = maze_ss.tri_chunk
    bank = maze_ss._bank
    sp = bank.pg_verts9.shape[2]
    if (tc, sp, maze_ss.plan["chunk_starts"]) != (496, 608, [0, 112]):
        raise AssertionError(f"{MAZE_ID} supersample=2 B={maze_ss.num_envs} plans "
                             f"{maze_ss.plan}, Sp={sp}")
    state = random_maze_states(maze_ss, gen)
    cam = rc.camera_grid(state, 2 * W, 2 * H)
    tri = (bank.pg_verts9, bank.pg_attr, state.layout_id, cam, maze_ss._all_quads)
    paired = (bank.pg_verts9_alt, bank.pg_attr_alt, maze_ss._pg_wall, state.wall_open)
    sl = slice(0, 1024)
    sub = (*tri[:2], state.layout_id[sl], cam_rows(cam, sl), tri[4])
    sub_paired = (*paired[:3], state.wall_open[sl])
    case = (f"{MAZE_ID} procgen ss=2 B={sub[2].shape[0]} samples={2 * W}x{2 * H} Sp={sp} "
            f"2 chunks of {tc}")
    _, _, err = check_tri_pass(sub, case, paired=sub_paired, tri_chunk=tc)
    err = max(err, check_tri_pass(sub, case, paired=sub_paired, tri_chunk=tc,
                                  attr_dtype=torch.float32)[2])
    keys = torch.randint(0, 1 << 32, sub[2].shape, generator=gen).to(dev)
    zeros = torch.zeros((1, sp, 4), device=dev)
    override = (keys, spread_tex(zeros, gen), spread_tex(zeros, gen))
    e, changed = check_override(sub, override, case + " synthetic variants", paired=sub_paired,
                                tri_chunk=tc)
    err = max(err, e)
    if changed < 0.2:
        raise AssertionError(f"{case}: the synthetic variants change only {changed:.3f}")
    ties, t_paired = paired_tie_case(dev)
    t_k, a_k, e = check_tri_pass(ties, f"paired ties B={B_STAGE} Sp=608 2 chunks of 496",
                                 paired=t_paired, tri_chunk=496)
    err = max(err, e)
    _, a_one = rc.tri_pass_plain(*ties, paired=t_paired)
    decided = int((a_one != a_k).any(-1).sum())
    say("tie-case", route="paired", tri_chunk=496, chunk_starts="0,112",
        px_hit=f"{float(torch.isfinite(t_k).float().mean()):.3f}",
        px_decided_by_chunk_rule=decided)
    if decided < 100:
        raise AssertionError(f"the paired tie case decides only {decided} pixels")
    # the plain scan takes seconds at these shapes: one timed call, no warm-up
    timings = (cuda_ms(lambda: rc.tri_pass(*tri, None, paired, tc), 50),
               cuda_ms(lambda: plain_tri_pass(tri, None, paired, tc), 1, 0))
    stats = tri_cull_stats(tri, paired, block=16)
    work = tri_work(tri, stats["hit_pairs"], paired)
    shapes = (f"{MAZE_ID} procgen ss=2 B={maze_ss.num_envs} samples={2 * W}x{2 * H} Sp={sp} "
              f"tri_chunk={tc}")
    say("kernel-time", kernel="tri_pass", instance="paired 2 chunks", ms=f"{timings[0]:.4f}",
        plain_ms=f"{timings[1]:.4f}", bound_ms=f"{bound(*work)[0]:.4f}",
        bound_by=bound(*work)[1], hit_rows_per_sample=f"{stats['hits_per_px'] / 4:.4f}",
        shapes=shapes)
    say_window(f"{MAZE_ID} procgen ss=2 paired 2 chunks", tri, paired)
    return err, timings, work, maze_ss_stages(maze_ss, state, tri, paired, shapes)


def maze_ss_stages(maze_ss, state, tri, paired, shapes):
    """entity_pass and the SS=2 pixel_epilogue at the Maze 8x8 procgen
    supersample=2 path's shapes (B=8192, 160x120 samples, on the paired
    tri_pass's hits): each against its plain version (the epilogue
    exactly) and timed. Returns {"entity_pass" | "pixel_epilogue_ss2":
    (ms, plain ms, work, max abs error)}."""
    from miniworld_tpu_torch.render import raycast as rc

    cam = tri[3]
    t_k, a_k = rc.tri_pass(*tri, None, paired, maze_ss.tri_chunk)
    ent = (state.ent_pos, state.ent_size, state.ent_dir, state.ent_height, state.ent_color,
           rc.entity_flags(maze_ss._bank, state), cam, *maze_ss._shapes_present[:2])
    e_k, e_p = rc.entity_pass(*ent), rc.entity_pass_plain(*ent)
    ent_err = check_entity_pass(e_k, e_p, shapes)
    lights = (state.light_pos, state.light_color, state.light_ambient, state.sky_color)
    args = (t_k, a_k, *e_k, maze_ss._atlas, cam, *lights, maze_ss.fourier_k)
    table = maze_ss._fourier_table
    rgb_k, d_k = rc.pixel_epilogue(*args, table=table, ss=2)
    rgb_p, d_p = rc.pixel_epilogue_plain(*args, ss=2)
    n_rgb, n_depth = int((rgb_k != rgb_p).any(-1).sum()), int((d_k != d_p).sum())
    rgb_err = float((rgb_k.int() - rgb_p.int()).abs().max())
    say("kernel-vs-plain", kernel="pixel_epilogue", instance="SS=2", case=shapes,
        rgb_differs_px=n_rgb, depth_differs_px=n_depth, exact=True)
    if n_rgb or n_depth:
        raise AssertionError(f"pixel_epilogue SS=2 ({shapes}): kernel differs from plain on "
                             f"{n_rgb} RGB and {n_depth} depth pixels")
    ent_wk, ent_full = ent_work(ent[5], e_p[0], cam.width, cam.height)
    ent_dev = kernel_ms(lambda: rc.entity_pass(*ent), 50, "entity_pass_kernel")
    out = {
        "entity_pass": (cuda_ms(lambda: rc.entity_pass(*ent), 50),
                        cuda_ms(lambda: rc.entity_pass_plain(*ent), 1, PLAIN_WARMUP), ent_wk,
                        ent_err),
        "pixel_epilogue_ss2": (cuda_ms(lambda: rc.pixel_epilogue(*args, table=table, ss=2), 50),
                               cuda_ms(lambda: rc.pixel_epilogue_plain(*args, ss=2), 1,
                                       PLAIN_WARMUP),
                               epi_work(args, table, maze_ss.fourier_k, 2), rgb_err)}
    terms = texel_reads(t_k, a_k, e_k[0], table.shape[0])[1] * maze_ss.fourier_k
    out["pixel_epilogue_ss2"] += (issue_floor_ms(terms, sass_term_instructions(16, False)),)
    for k, (ms, plain_ms, wk, _, *floor) in out.items():
        extra = ({"issue_floor_ms": fmt_ms(floor[0])} if k == "pixel_epilogue_ss2" else
                 {"bound_full_scan_ms": f"{bound(*ent_full)[0]:.4f}",
                  "device_ms": fmt_ms(ent_dev)})
        say("kernel-time", kernel=k, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound(*wk)[0]:.4f}", bound_by=bound(*wk)[1], **extra, shapes=shapes)
    out["entity_pass"] += (ent_full, ent_dev)
    return out


# ---------------------------------------------------------------------------
# scheduled tri_pass (packed PVS over more than one chunk, its mesh-seeded
# form, chunk_vis): the SCHED instances


def sched_route(env, state):
    """(tri_args, mesh, override) of the env's render of ``state`` at its
    own samples: static_rows' one-chunk rows and (B, n) schedule, the mesh
    rows and the override from its slot table, as render_rgbd passes them
    to tri_pass. Raises unless the plan is a schedule."""
    from miniworld_tpu_torch.render import raycast as rc

    ss = env.supersample
    cam = rc.camera_grid(state, env.obs_width * ss, env.obs_height * ss)
    rows, paired = rc.static_rows(env._bank, state, cam, env._pg_wall, env.plan)
    if rows[2].dim() != 2 or paired is not None:
        raise AssertionError(f"{env.spec.gym_id} B={env.num_envs} plans {env.plan['kind']} "
                             f"sched_len {env.plan['sched_len']}: no schedule")
    mesh = rc.entity_mesh_rows(env._bank, state)[:2] if env._shapes_present[2] else None
    override = None if env._slot_tex is None else (state.tri_slots, *env._slot_tex)
    return (*rows, cam, env._all_quads), mesh, override


def sub_route(route, n):
    """The first n envs of a sched_route."""
    (v9, at, sched, cam, quads), mesh, override = route
    sl = slice(0, n)
    return ((v9, at, sched[sl], cam_rows(cam, sl), quads),
            None if mesh is None else tuple(m[sl] for m in mesh),
            None if override is None else (override[0][sl], *override[1:]))


def sched_ties(dev, n=B_STAGE, seed=41):
    """Two tie banks of one-chunk rows in front of n cameras (tie_cameras):
    (a) the 4 chunks of 256 of tie_case (a group, the group again at the
    same local indices, rolled, new prims) under random schedules of 4
    positions, repeats included (a clamped or padded slot), where the
    position decides ties; (b) 2 chunks of 1,024 whose local row 1,023 is
    a copy of mesh triangle 0 (chunk 0) or 1 (chunk 1), the other rows far
    quads, with 16 mesh triangles, so that a static row and the mesh seed
    meet at equal quantized depth (the seed's key ends in 1,023 ones).
    Returns ((tri_args, None), (tri_args, mesh))."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    v9, at, _, cam, quads = tie_case(dev, n)
    g = v9.shape[2] // 4
    rows9 = v9.view(9, 4, g).transpose(0, 1).contiguous()
    rows_at = at.view(4, g, 16).contiguous()
    sched = torch.from_numpy(rng.integers(0, 4, (n, 4)).astype(np.int32)).to(dev)
    rep = (rows9, rows_at, sched, cam, quads)
    cam = tie_cameras(dev, n, rng)
    k, m = 1024, 16
    v0 = np.stack([rng.uniform(4, 8, m), rng.uniform(0.0, 2.5, m), rng.uniform(-2, 2, m)])
    tri = np.concatenate([v0, v0 + rng.uniform(-3, 3, (3, m)), v0 + rng.uniform(-3, 3, (3, m))])
    # the two copied triangles: large, upright at x = 6 and 6.5, both windings
    tri[:, 0] = [6.0, 0.2, -3.0, 6.0, 0.2, 3.0, 6.0, 3.0, 0.0]
    tri[:, 1] = [6.5, 0.2, -3.0, 6.5, 3.0, 0.0, 6.5, 0.2, 3.0]
    far = np.concatenate([np.stack([rng.uniform(12, 20, k), rng.uniform(0, 2.5, k),
                                    rng.uniform(-4, 4, k)])] * 3)
    far[3:6] += rng.uniform(-3, 3, (3, k))
    far[6:9] += rng.uniform(-3, 3, (3, k))
    chunks = np.stack([far, far[:, ::-1]]).astype(f32)  # (2, 9, k)
    chunks[0, :, k - 1] = tri[:, 0]
    chunks[1, :, k - 1] = tri[:, 1]
    attrs = rng.uniform(-1, 1, (2, k, 16)).astype(f32)
    attrs[:, :, 15] = (rng.uniform(size=(2, k)) < 0.5).astype(f32)
    attrs[:, k - 1, 15] = 1.0  # the copies are triangles, as mesh rows are
    mesh_at = rng.uniform(-1, 1, (n, m, 16)).astype(f32)
    mesh_at[:, :, 15] = 1.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    seeded = (t(chunks), t(attrs), torch.tensor([[0, 1]] * n, dtype=torch.int32, device=dev),
              cam, False)
    mesh = (t(np.broadcast_to(tri.astype(f32), (n, 9, m))), t(mesh_at))
    return (rep, None), (seeded, mesh)


def phase_sched_stages(cases, timed_cases):
    """[sched-stages]: the SCHED instances of tri_pass against
    tri_pass_scheduled on every pixel, t and the 16 attributes: each
    case's route (``cases`` = [(label, env, state, n)], the first n envs;
    the plain SCHED, SCHED x OVERRIDE with the bank's variants and with
    synthetic ones, SCHED x MESH, SCHED x F32 with the float32 carry), the
    tie banks of ``sched_ties`` (the position rule, repeated chunks, the
    mesh seed against a static row at equal key), then ``timed_cases`` =
    [(label, env, state)] checked whole and timed (the kernel over 50
    launches, the plain version once). Returns (max abs t error, {label:
    (ms, plain ms)}, {label: work}, checked labels)."""
    from miniworld_tpu_torch.render import raycast as rc

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(1166)
    err, checked = 0.0, []
    for label, env, state, n in cases:
        tri, mesh, override = sub_route(sched_route(env, state), n)
        sched = tri[2]
        repeats = int((sched[:, 1:] == sched[:, :-1]).any(1).sum())
        case = (f"{label} B={sched.shape[0]} samples={tri[3].width}x{tri[3].height} "
                f"rows {tri[0].shape[0]}x{tri[0].shape[2]} sched_len={sched.shape[1]} "
                f"envs_with_a_repeat={repeats}{' mesh' if mesh else ''}")
        t_k, _, e = check_tri_pass(tri, case, mesh, override=override)
        err = max(err, e)
        if float(torch.isfinite(t_k).float().mean()) < 0.3:
            raise AssertionError(f"{case}: only {float(torch.isfinite(t_k).float().mean()):.3f} "
                                 "of the samples hit a prim")
        if override is not None:
            synth = (override[0], spread_tex(override[1], gen), None)
            e, changed = check_override(tri, synth, case + " synthetic variants", mesh)
            err = max(err, e)
            if changed < 0.2:
                raise AssertionError(f"{case}: the synthetic variants change only {changed:.3f}")
        if mesh is None and override is None:  # the float32 carry on the same rows
            _, _, e = check_tri_pass(tri, case + " f32 carry", attr_dtype=torch.float32)
            err = max(err, e)
        checked.append(label)
    (rep, _), (seeded, mesh) = sched_ties(dev)
    t_k, a_k, e = check_tri_pass(rep, f"sched ties B={B_STAGE} 4 chunks of 256, random "
                                 "schedules with repeats")
    err = max(err, e)
    _, a_rev = rc.tri_pass_scheduled(*rep[:2], rep[2].flip(1).contiguous(), *rep[3:])
    decided = int((a_rev != a_k).any(-1).sum())
    repeats = int(torch.stack([(rep[2][:, j:j + 1] == rep[2][:, :j]).any(1)
                               for j in range(1, 4)], 1).any(1).sum())
    say("tie-case", route="sched", chunks="4x256", envs_with_a_repeated_chunk=repeats,
        px_decided_by_position=decided)
    if decided < 100 or repeats < B_STAGE // 4:
        raise AssertionError(f"the schedule tie case decides {decided} pixels, repeats in "
                             f"{repeats} envs")
    t_k, a_k, e = check_tri_pass(seeded, f"sched mesh ties B={B_STAGE} 2 chunks of 1024", mesh)
    err = max(err, e)
    t_s, _ = rc.tri_pass_scheduled(*seeded)  # the static rows alone
    t_m, a_m = rc.entity_mesh_pass_plain(*mesh, seeded[3])
    # equal quantized depth; the seed's key is its t's round trip, so at
    # some of these pixels it falls one quantum below and the static row wins
    tie = torch.isfinite(t_m) & (t_s == t_m)
    kept = int((tie & (a_k == a_m).all(-1)).sum())
    say("tie-case", route="sched mesh", chunks="2x1024", px_equal_depth=int(tie.sum()),
        px_seed_kept_at_equal_depth=kept)
    if kept < 100:
        raise AssertionError(f"the mesh tie case keeps the seed on {kept} of "
                             f"{int(tie.sum())} equal-depth pixels")
    checked += ["ties: position, repeated chunks", "ties: mesh seed at equal key"]
    timings, work = {}, {}
    for label, env, state in timed_cases:
        tri, mesh, override = sched_route(env, state)
        case = (f"{label} B={env.num_envs} samples={tri[3].width}x{tri[3].height} "
                f"rows {tri[0].shape[0]}x{tri[0].shape[2]} sched_len={tri[2].shape[1]}"
                f"{' mesh' if mesh else ''}")
        _, _, e = check_tri_pass(tri, case, mesh, override=override)
        err = max(err, e)
        checked.append(label + f" B={env.num_envs}")
        timings[label] = (cuda_ms(lambda: rc.tri_pass(*tri, mesh, None, None, override), 50),
                          cuda_ms(lambda: plain_tri_pass(tri, mesh, None, None, override), 1,
                                  PLAIN_WARMUP))
        stats = tri_cull_stats(tri, block=16)
        mesh_work = None
        if mesh is not None:
            mesh_work = (mesh[0], tri_cull_stats(tri, block=16, mesh_rows9=mesh[0])["hit_pairs"])
        work[label] = tri_work(tri, stats["hit_pairs"], None, override, mesh=mesh_work)
        clamped = int((tri[2][:, 1:] == tri[2][:, :-1]).any(1).sum())
        say("kernel-time", kernel="tri_pass",
            instance="sched" + (" mesh" if mesh else "") + (" override" if override else ""),
            ms=f"{timings[label][0]:.4f}", plain_ms=f"{timings[label][1]:.4f}",
            bound_ms=f"{bound(*work[label])[0]:.4f}", bound_by=bound(*work[label])[1],
            hit_rows_per_sample=f"{stats['hits_per_px']:.4f}",
            envs_with_a_clamped_slot=clamped, shapes=case)
    return err, timings, work, checked


def check_render_stages(env, state, label, route=None):
    """The env's render of ``state`` at its main path's shapes, through the
    kernels against the plain versions: entity_pass against
    entity_pass_plain (exactly, check_entity_pass), the SS pixel_epilogue
    against pixel_epilogue_plain on the kernels' hits (exact), then the
    whole render, env.render with use_kernels False (RGB and depth equal).
    ``route`` (sched_route by default) gives tri_pass's inputs. Returns the
    max abs entity t error."""
    from miniworld_tpu_torch.render import raycast as rc

    ss = env.supersample
    tri, mesh, override = (route or sched_route)(env, state)
    cam = tri[3]
    t_k, a_k = rc.tri_pass(*tri, mesh, None, None, override)
    case = (f"{label} B={env.num_envs} out={env.obs_width}x{env.obs_height} "
            f"samples={cam.width}x{cam.height}")
    if not (env._shapes_present[0] or env._shapes_present[1]):
        raise AssertionError(f"{case}: no analytic entities for entity_pass")
    ent = (state.ent_pos, state.ent_size, state.ent_dir, state.ent_height, state.ent_color,
           rc.entity_flags(env._bank, state), cam, *env._shapes_present[:2])
    e_k, e_p = rc.entity_pass(*ent), rc.entity_pass_plain(*ent)
    ent_err = check_entity_pass(e_k, e_p, case)
    lights = (state.light_pos, state.light_color, state.light_ambient, state.sky_color)
    args = (t_k, a_k, *e_k, env._atlas, cam, *lights, env.fourier_k)
    outs = {"stage": (rc.pixel_epilogue(*args, table=env._fourier_table, ss=ss),
                      rc.pixel_epilogue_plain(*args, ss=ss))}
    kernels = env.render(state)
    env.use_kernels = False
    try:
        outs["render"] = (kernels, env.render(state))
    finally:
        env.use_kernels = True
    for what, ((rgb_k, d_k), (rgb_p, d_p)) in outs.items():
        n_rgb, n_depth = int((rgb_k != rgb_p).any(-1).sum()), int((d_k != d_p).sum())
        say("kernel-vs-plain", kernel="pixel_epilogue" if what == "stage" else "render",
            instance=f"SS={ss}", case=case, rgb_differs_px=n_rgb, depth_differs_px=n_depth,
            exact=True)
        if n_rgb or n_depth or rgb_k.shape != (env.num_envs, env.obs_height, env.obs_width, 3):
            raise AssertionError(f"{case} {what}: kernels differ from plain on {n_rgb} RGB and "
                                 f"{n_depth} depth pixels")
    return ent_err


def phase_sched_paths(maze_bank, maze_bank_dr, bank_states, big, small, rates):
    """The scheduled main paths: the 8x8 Maze's layout bank at B=1024,
    160x120 with supersample=2 (packed PVS, 2 chunks of 96), with its
    breakdown and profile, and with domain randomisation (SCHED x
    OVERRIDE), each first rendered from its state in ``bank_states``
    through the kernels and the plain versions (check_render_stages);
    ThreeRooms (mesh rows: SCHED x MESH), FourRooms and the MazeS3 bank
    with tri_chunk=16 at B=1024, 80x60 (``big``: {id: env}), and at
    B_PLAIN (``small``) against their plain paths. Returns ({label:
    launches}, the max abs entity t error of the render checks)."""
    launches = {}
    ent_err = max(check_render_stages(env, st, label) for env, st, label in (
        (maze_bank, bank_states[0], "maze8x8-bank ss=2"),
        (maze_bank_dr, bank_states[1], "maze8x8-bank ss=2 domain_rand")))
    for env, label, horizon in ((maze_bank, "maze_bank", HORIZON),
                                (maze_bank_dr, "maze_bank_dr", SHORT_HORIZON)):
        rate, outs, obs, launches[label], _ = rollouts(env, "sched", horizon, TRIALS)
        check_rollout(env, outs, obs, launches[label], horizon, TRIALS, path_kernels(env))
        rates[f"maze8x8_bank_ss2{'_dr' if env.domain_rand else ''}_b{env.num_envs}"] = (rate, None)
    phase_breakdown(maze_bank, render_iters=5, plain_render_iters=0)
    for env_id, _ in SCHED_IDS:
        for env in (big[env_id], small[env_id]):
            if "tri_pass_sched" not in path_kernels(env):
                raise AssertionError(f"{env_id} tri_chunk=16 B={env.num_envs} plans {env.plan}")
            name = env.spec.name.lower() + f"_tri_chunk16_b{env.num_envs}"
            if env.num_envs == B:
                rate, outs, obs, launches[name], _ = rollouts(env, "sched", SHORT_HORIZON,
                                                              TRIALS)
                check_rollout(env, outs, obs, launches[name], SHORT_HORIZON, TRIALS,
                              path_kernels(env))
                rates[name] = (rate, None)
            else:
                rates[name] = kernel_and_plain(env, PLAIN_HORIZON, TRIALS,
                                               path_kernels(env))[:2]
    return launches, ent_err


def clamped_states(env, state, per_room=8):
    """The states with their last envs moved to the centres of the first
    two (layout, room) pairs whose packed schedule runs past the layout's
    last chunk (base + sched_len > NC: JAX's one-hot read leaves the
    layout there, the port's clamp repeats the last chunk), ``per_room``
    yaws each. Returns (state, names of the pairs)."""
    plan, bank = env.plan, env._bank_np
    over = np.argwhere(bank.room_mask & (bank.pvs_room_base + plan["sched_len"] > plan["nc"]))
    pairs = [tuple(int(v) for v in p) for p in over[:2]]
    n = len(pairs) * per_room
    lid, pos, yaw = state.layout_id.clone(), state.pos.clone(), state.dir.clone()
    for i, (li, r) in enumerate(pairs):
        a = bank.room_aabb[li, r]
        sl = slice(env.num_envs - n + i * per_room, env.num_envs - n + (i + 1) * per_room)
        lid[sl] = li
        pos[sl] = torch.tensor([0.5 * (a[0] + a[1]), 0.0, 0.5 * (a[2] + a[3])])
        yaw[sl] = torch.arange(per_room, dtype=torch.float32) * (2 * math.pi / per_room)
    return state.replace(layout_id=lid, pos=pos, dir=yaw), pairs


def chunk_vis_env(make):
    """The env ``make()`` builds, planned with the packed planner switched
    off: JAX's chunk_vis plan where culling pays (no id plans it at its
    defaults; the 8x8 Maze's layout bank at 160x120 supersample=2, B=1024:
    8 of its 16 chunks of 32)."""
    from miniworld_tpu_torch import vector

    planner = vector.plan_packed_pvs
    vector.plan_packed_pvs = lambda bank, cap, over: (None, cap, None, math.inf)
    try:
        return make()
    finally:
        vector.plan_packed_pvs = planner


@contextlib.contextmanager
def shared_banks():
    """Within the block, ``vector.build_bank`` builds each (id, layouts,
    texture mode) once: the 8x8 Maze's 64 layouts take ~46 s on the card's
    host, and the domain_rand path's env compiles the same bank (its
    texture variants are drawn at reset and render time);
    ``vector.build_super_bank`` each (id, texture mode, K) once."""
    from miniworld_tpu_torch import vector

    orig, orig_super, built = vector.build_bank, vector.build_super_bank, {}

    def build_bank(spec, tex_mode="fourier", **kw):
        key = (spec.gym_id, spec.num_layouts, tex_mode, repr(sorted(kw.items())))
        if key not in built:
            built[key] = orig(spec, tex_mode, **kw)
        return built[key]

    def build_super_bank(spec, tex_mode="fourier", fourier_k=None):
        key = ("super", spec.gym_id, tex_mode, fourier_k)
        if key not in built:
            built[key] = orig_super(spec, tex_mode, fourier_k)
        return built[key]

    vector.build_bank, vector.build_super_bank = build_bank, build_super_bank
    try:
        yield
    finally:
        vector.build_bank, vector.build_super_bank = orig, orig_super


def phase_glyph_paths(sign, maze_ss, make_env, rates):
    """The new main paths: Sign at B=1024 (K=64, dict observations, the
    GAIN epilogue and mesh rows every step) and the Maze 8x8 procgen one
    at B=8192 with supersample=2 (the paired tri_pass over 2 chunks of
    496), each with its breakdown and profile; short B=1024 rollouts of
    GreenKey and ThreeRooms; kernel-vs-plain rollouts at B_PLAIN of Sign
    (exact: checksums too), GreenKey and ThreeRooms. Returns {label:
    launches}."""
    launches = {}
    for env, label in ((sign, "sign_b1024"), (maze_ss, "maze8x8_procgen_ss2_b8192")):
        rate, outs, obs, lc, _ = rollouts(env, label, HORIZON, TRIALS)
        check_rollout(env, outs, obs, lc, HORIZON, TRIALS, path_kernels(env))
        rates[label] = (rate, None)
        launches[label] = lc
        phase_breakdown(env, render_iters=5, plain_render_iters=0)
    for env_id in (GREEN_ID, THREE_ID):
        env = make_env(env_id, B)
        rate, outs, obs, lc, _ = rollouts(env, "kernels", SHORT_HORIZON, TRIALS)
        check_rollout(env, outs, obs, lc, SHORT_HORIZON, TRIALS, path_kernels(env))
        rates[env.spec.name.lower()] = (rate, None)
    for env_id in (SIGN_ID, GREEN_ID, THREE_ID):
        env = make_env(env_id, B_PLAIN)
        rate, plain_rate, _, _ = kernel_and_plain(env, PLAIN_HORIZON, TRIALS, path_kernels(env),
                                                  exact=env_id == SIGN_ID)
        rates[env.spec.name.lower() + f"_b{B_PLAIN}"] = (rate, plain_rate)
    return launches


def path_kernels(env):
    """The kernels every step of the env's rollout launches: tri_pass, the
    epilogue and place, entity_pass with analytic entities, the mesh rows
    in tri_pass with mesh entities, mazegen on a procgen maze, and the
    instances its statics take (the glyph epilogue, SS=2, the multi-chunk
    kernel, the paired scan over more than one chunk, the nearest
    epilogue, the float32 carry), and the mesh rows' own kernel with mesh
    entities; with view="top" the top view's kernels instead of the
    render's; the in-step placement on CollectHealth."""
    if env.view == "top":  # the top view's two kernels and the reset's
        return (("tri_pass_ortho", "topview_epilogue", "place")
                + (("place_one",) if env.spec.name == "CollectHealth" else ())
                + (("mazegen",) if env.procgen else ())
                + (("topview_epilogue_nearest",) if env.tex_mode == "nearest" else ()))
    present = env._shapes_present
    names = ["tri_pass", "pixel_epilogue", "place"]
    names += ["place_one"] if env.spec.name == "CollectHealth" else []
    names += ["entity_pass"] if present[0] or present[1] else []
    names += ["entity_mesh_pass", "entity_mesh_rows"] if present[2] else []
    names += ["mazegen"] if env.procgen else []
    names += ["pixel_epilogue_gain"] if env._has_gain else []
    names += ["pixel_epilogue_ss2"] if env.supersample == 2 else []
    names += (["tri_pass_paired_chunks"] if env._pg_wall is not None
              and len(env.plan["chunk_starts"]) > 1 else [])
    names += ["tri_pass_active"] if env._row_code is not None else []
    bank = env._bank
    n_rows = (bank.pg_verts9 if env._pg_wall is not None else bank.tri_verts9).shape[2]
    names += ["tri_pass_multi"] if bank.pvs_v9_rows is None and n_rows > env.tri_chunk else []
    plan = env.plan
    names += ["tri_pass_sched"] if (env._bank.pvs_v9_rows is not None
                                    and (plan["sched_len"] or plan["nc"]) > 1) else []
    names += ["tri_pass_override"] if env._slot_tex is not None else []
    if env.tex_mode == "nearest":
        names += ["pixel_epilogue_nearest"]
    n_ids = env._bank.tex_slot_base.shape[1] if env.tex_mode == "nearest" else env._atlas.shape[0]
    if n_ids > 256:  # the float32 carry
        names += ["tri_pass_f32", "pixel_epilogue_f32"]
    return tuple(names)


# ---------------------------------------------------------------------------
# nearest-mode textures (the F32 tri_pass, the NEAREST epilogue) and the
# continuous-action ids


def view_states(env, gen, seed=7):
    """States whose frames show the env's scene: each agent in a random
    cell of a procgen maze, facing an entity (PickupObjects), in front of
    the sign (Sign), or spread over the rooms of the first layout; the
    cameras spread further than domain randomisation draws them
    (widen_cameras)."""
    if env.procgen:
        state = random_maze_states(env, gen, seed=seed)
    elif env.spec.gym_id == PICK_ID:
        state = facing_states(env, gen, (0.5, 0.5), (11.5, 11.5), seed=seed)
    elif env.spec.gym_id == SIGN_ID:
        state = sign_states(env, gen, seed=seed)
    else:
        aabb = env._bank_np.room_aabb[0][env._bank_np.room_mask[0]]
        state = spread_states(env, gen, (float(aabb[:, 0].min()), float(aabb[:, 2].min())),
                              (float(aabb[:, 1].max()), float(aabb[:, 3].max())), seed=seed)
    return widen_cameras(state, gen)


def max_abs_diff(k, p):
    """max |k - p| over the elements, 0 where their bits are equal (the
    same infinity), inf where only one is finite."""
    bits = {4: torch.int32, 2: torch.int16, 1: torch.uint8}[k.element_size()]
    same = k.view(bits) == p.view(bits)
    return float(torch.where(same, 0.0, (k.float() - p.float()).abs()).max())


def check_nearest(label, env, state, tri_chunk=None):
    """The env's nearest render of ``state``, stage by stage, kernels
    against plain versions on the same inputs: tri_pass in the render's
    carry dtype (t and the 16 attributes bit for bit), then the NEAREST
    pixel_epilogue on the kernel's hits (u8 images and depth equal).
    ``tri_chunk`` overrides the env's plan (the chunks of B >= 1024 on a
    B=128 env). Returns the epilogue's and tri_pass's inputs and the max
    abs difference over t, the attribute rows, the u8 images and depth."""
    from miniworld_tpu_torch.render import cuda_build
    from miniworld_tpu_torch.render import raycast as rc

    ss = env.supersample
    cam = rc.camera_grid(state, W * ss, H * ss)
    carry = rc.attr_carry_dtype(state.tex_map.shape[1])
    mesh = (rc.entity_mesh_rows(env._bank, state, fourier=False)[:2] if env._shapes_present[2]
            else None)
    rows, paired = rc.static_rows(env._bank, state, cam, env._pg_wall, env.plan)
    tc = env.tri_chunk if tri_chunk is None else tri_chunk
    tri = (*rows, cam, env._all_quads)
    before = dict(cuda_build.LAUNCHES)
    t_k, a_k = rc.tri_pass(*tri, mesh, paired, tc, None, carry)
    t_p, a_p = plain_tri_pass(tri, mesh, paired, tc, attr_dtype=carry)
    bits = torch.int32 if carry == torch.float32 else torch.int16
    n_t = int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum())
    n_attr = int((a_k.view(bits) != a_p.view(bits)).any(-1).sum())
    ent = (None,) * 3
    if env._shapes_present[0] or env._shapes_present[1]:
        ent = rc.entity_pass(state.ent_pos, state.ent_size, state.ent_dir, state.ent_height,
                             state.ent_color, rc.entity_flags(env._bank, state), cam,
                             *env._shapes_present[:2])
    epi = (t_k, a_k, *ent, env._atlas, cam, state.light_pos, state.light_color,
           state.light_ambient, state.sky_color, env.fourier_k)
    rgb_k, d_k = rc.pixel_epilogue(*epi, ss=ss, tex_map=state.tex_map)
    rgb_p, d_p = rc.pixel_epilogue_plain(*epi, ss=ss, tex_map=state.tex_map)
    n_rgb = int((rgb_k != rgb_p).any(-1).sum())
    n_depth = int((d_k.view(torch.int32) != d_p.view(torch.int32)).sum())
    err = max(max_abs_diff(t_k, t_p), max_abs_diff(a_k, a_p), max_abs_diff(rgb_k, rgb_p),
              max_abs_diff(d_k, d_p))
    launched = {k: v - before[k] for k, v in cuda_build.LAUNCHES.items() if v > before[k]}
    multi = tri[0].shape[2] > tc
    textured = int((torch.isfinite(t_k) & (a_k[..., 14].float() >= 0)).sum())
    case = (f"{label} B={env.num_envs} samples={W * ss}x{H * ss} T={state.tex_map.shape[1]} "
            f"A={env._atlas.shape[0]} S={tri[0].shape[2]} tri_chunk={tc}"
            f"{' mesh' if mesh else ''}{' paired' if paired else ''}")
    say("kernel-vs-plain", kernel="tri_pass, pixel_epilogue",
        instance=f"{'F32' if carry == torch.float32 else 'bf16'}"
        f"{' multi-chunk' if multi else ''}, NEAREST SS={ss}", case=case,
        t_differs_px=n_t, attr_differs_px=n_attr, rgb_differs_px=n_rgb,
        depth_differs_px=n_depth, max_abs_err=f"{err:.3e}", textured_samples=textured,
        px_hit=f"{float(torch.isfinite(t_k).float().mean()):.3f}", launched=launched,
        exact=True)
    if n_t or n_attr or n_rgb or n_depth:
        raise AssertionError(f"nearest ({case}): kernels differ from plain on {n_t} t, "
                             f"{n_attr} attribute, {n_rgb} RGB and {n_depth} depth pixels")
    want = {"pixel_epilogue_nearest"} | ({"tri_pass_f32", "pixel_epilogue_f32"}
                                         if carry == torch.float32 else set())
    if not want <= set(launched) or textured < 0.1 * t_k.numel():
        raise AssertionError(f"nearest ({case}): launched {launched}, {textured} textured")
    return epi, (tri, paired, tc, carry), err


def nearest_epi_work(epi, tex_map):
    """(bytes, operations) of a NEAREST pixel_epilogue launch on ``epi``
    (its plain version's positional arguments up to k_terms): each
    sample's t read once, its attribute row (2 or 4 bytes a float) where
    the result reads it (texel_reads), of the entity pass's results what
    ent_read_bytes counts, tex_map, the u8
    atlas, lights and camera once,
    7 bytes out a pixel; 60 operations per sample for uv, lighting and
    the pack, 12 per sample whose texel the result reads (round, floor and
    subtract twice, two scales and clamps, three conversions and scales),
    4 per output pixel for the SS=2 box filter."""
    t_tri, attr, t_ent, atlas, cam = epi[0], epi[1], epi[2], epi[5], epi[6]
    b, hws = t_tri.shape
    ss = 2 if cam.width == 2 * W else 1
    n_out = hws // (ss * ss)
    read, textured = texel_reads(t_tri, attr, t_ent)
    in_bytes = b * hws * 4 + read * 16 * attr.element_size() + ent_read_bytes(t_tri, t_ent)
    return (in_bytes + tex_map.numel() * 4 + atlas.numel() + b * 48 + b * 14 * 4
            + (cam.width + cam.height) * 4 + b * n_out * 7,
            b * hws * 60 + textured * 12 + (b * n_out * 4 if ss > 1 else 0))


def phase_nearest_stages(cases, maze_n):
    """[nearest-stages]: check_nearest on every case, [(label, env,
    tri_chunk)] (at B_PLAIN: bf16 and F32 carries, one chunk, the MULTI
    scan, mesh rows, the 78-row atlas, the paired F32 scan over 2 chunks
    with the SS=2 epilogue, domain_rand's variants in tex_map; Hallway at
    the B=1024 of its nearest path); then at
    the Maze 8x8 procgen nearest main path's shapes (B=8192, 80x60,
    T=528: the F32 carry), checked the same way and timed: the F32
    tri_pass beside the same launch in bf16, and the NEAREST F32 epilogue,
    each with its plain version. Returns (the max abs difference of every
    check, {name: (ms, plain ms)}, {name: work}, {label checked: its carry
    is float32})."""
    from miniworld_tpu_torch.render import raycast as rc

    gen = torch.Generator().manual_seed(727)
    checked, errs = {}, []
    for label, env, tc in cases:
        _, (_, _, _, carry), err = check_nearest(label, env, view_states(env, gen), tc)
        checked[label] = carry == torch.float32
        errs.append(err)
    state = random_maze_states(maze_n, gen, seed=11)
    epi, (tri, paired, tc, carry), err = check_nearest("maze8x8-procgen", maze_n, state)
    errs.append(err)
    if carry != torch.float32 or tri[0].shape[2] > tc:
        raise AssertionError(f"{MAZE_ID} nearest B={B_MAZE}: carry {carry}, tri_chunk {tc}")
    tex_map = state.tex_map
    timings = {
        "tri_pass_f32": (cuda_ms(lambda: rc.tri_pass(*tri, None, paired, tc, None, carry), 50),
                         cuda_ms(lambda: plain_tri_pass(tri, None, paired, tc,
                                                        attr_dtype=carry), 1, PLAIN_WARMUP)),
        "tri_pass_bf16": (cuda_ms(lambda: rc.tri_pass(*tri, None, paired, tc), 50), None),
        "pixel_epilogue_nearest": (
            cuda_ms(lambda: rc.pixel_epilogue(*epi, tex_map=tex_map), 50),
            cuda_ms(lambda: rc.pixel_epilogue_plain(*epi, tex_map=tex_map), 1, PLAIN_WARMUP)),
    }
    stats = tri_cull_stats(tri, paired, block=64)
    work = {"tri_pass_f32": tri_work(tri, stats["hit_pairs"], paired, attr_bytes=64),
            "tri_pass_bf16": tri_work(tri, stats["hit_pairs"], paired),
            "pixel_epilogue_nearest": nearest_epi_work(epi, tex_map)}
    shapes = f"{MAZE_ID} procgen nearest B={B_MAZE} HW={W * H} Sp={tri[0].shape[2]} T=528"
    for name, (ms, plain) in timings.items():
        say("kernel-time", kernel=name, ms=f"{ms:.4f}",
            plain_ms="not measured" if plain is None else f"{plain:.4f}",
            bound_ms=f"{bound(*work[name])[0]:.4f}", bound_by=bound(*work[name])[1],
            shapes=shapes)
    checked[f"maze8x8-procgen B={B_MAZE}"] = True
    return max(errs), timings, work, checked


def phase_nearest_paths(maze_n, hall_n, make_env, rates):
    """The nearest main paths: the Maze 8x8 procgen one at B=8192 (the F32
    tri_pass and NEAREST F32 epilogue every step), with its breakdown and
    profile, and a short Hallway one at B=1024 (``hall_n``, bf16 carry); Hallway
    nearest at B_PLAIN against its plain path, exactly. Returns the
    Maze path's launches."""
    rate, outs, obs, launches, _ = rollouts(maze_n, "nearest", HORIZON, TRIALS)
    check_rollout(maze_n, outs, obs, launches, HORIZON, TRIALS, path_kernels(maze_n))
    rates["maze8x8_procgen_nearest_b8192"] = (rate, None)
    phase_breakdown(maze_n, render_iters=5, plain_render_iters=0)
    rate, outs, obs, lc, _ = rollouts(hall_n, "nearest", SHORT_HORIZON, TRIALS)
    check_rollout(hall_n, outs, obs, lc, SHORT_HORIZON, TRIALS, path_kernels(hall_n))
    rates["hallway_nearest"] = (rate, None)
    env = make_env(ENV_ID, B_PLAIN, tex_mode="nearest")
    rates[f"hallway_nearest_b{B_PLAIN}"] = kernel_and_plain(
        env, PLAIN_HORIZON, TRIALS, path_kernels(env), exact=True)[:2]
    return launches


def room_stage_checks(room):
    """Each render stage's kernel against its plain version at the
    RoomObjects main path's shapes (B=4096, no ceiling, the box and key as
    mesh rows in the tri_pass launch, the ball analytic), each agent
    facing one of its entities. Returns {kernel: max abs error}."""
    from miniworld_tpu_torch.render import raycast as rc

    gen = torch.Generator().manual_seed(4096)
    aabb = room._bank_np.room_aabb[0][room._bank_np.room_mask[0]]
    state = facing_states(room, gen, (float(aabb[:, 0].min()) + 0.5, float(aabb[:, 2].min()) + 0.5),
                          (float(aabb[:, 1].max()) - 0.5, float(aabb[:, 3].max()) - 0.5))
    _, tri, ent, epi = stage_inputs(room, state)
    rows9, row_attrs, valid = rc.entity_mesh_rows(room._bank, state)
    errs, outs = run_stage_checks(
        tri, ent, epi, f"roomobjects B={room.num_envs} HW={W * H} S={tri[0].shape[2]} "
        f"E*M={rows9.shape[2]}", mesh=(rows9, row_attrs))
    say("roomobjects-scene", px_hit=f"{float(torch.isfinite(outs[0]).float().mean()):.3f}",
        live_mesh_rows=int(valid.sum()))
    return errs


def phase_continuous(room, make_env, rates):
    """The continuous-action ids: RoomObjects' render stages at B=4096
    against their plain versions (room_stage_checks); RoomObjects at
    B=4096 (placement at budget 48 with agent radius 1.5, a ball, a box
    and a key as mesh rows, actions drawn as (B, 6) vectors) with its
    breakdown and profile, a short PutNext rollout at B=1024, and both at
    B_PLAIN against their plain paths. Returns RoomObjects' launches and
    the stage checks' {kernel: max abs error}."""
    if room.spec.place_budget != 48 or room._action_table is not None:
        raise AssertionError("RoomObjects: budget 48 and the raw 6-D actions expected")
    from miniworld_tpu_torch.ops.rng import key_data

    if room.plan["kind"] != "dense" or room._bank.tri_verts9.shape[2] > room.tri_chunk:
        raise AssertionError(f"RoomObjects plans {room.plan}")
    stage_errs = room_stage_checks(room)
    acts = room.rollout_actions(key_data(3, room.device), 2)
    lo = torch.tensor([-1.0, -1.0, -1.0, -1.0, 0.0, 0.0], device=room.device)
    if acts.shape != (2, room.num_envs, 6) or bool((acts < lo).any() | (acts >= 1.0).any()):
        raise AssertionError(f"continuous actions {tuple(acts.shape)} outside their box")
    rate, outs, obs, launches, _ = rollouts(room, "continuous", HORIZON, TRIALS)
    check_rollout(room, outs, obs, launches, HORIZON, TRIALS, path_kernels(room))
    rates["roomobjects_b4096"] = (rate, None)
    phase_breakdown(room, render_iters=5, plain_render_iters=0)
    put = make_env(PUTNEXT_ID, B)
    rate, outs, obs, lc, _ = rollouts(put, "continuous", SHORT_HORIZON, TRIALS)
    check_rollout(put, outs, obs, lc, SHORT_HORIZON, TRIALS, path_kernels(put))
    rates["putnext"] = (rate, None)
    for env_id in (ROOM_ID, PUTNEXT_ID):
        env = make_env(env_id, B_PLAIN)
        rates[env.spec.name.lower() + f"_b{B_PLAIN}"] = kernel_and_plain(
            env, PLAIN_HORIZON, TRIALS, path_kernels(env))[:2]
    return launches, stage_errs


# ---------------------------------------------------------------------------
# the last three ids: CollectHealth (the in-step placement, place_one; 864
# mesh rows a render) and the camera ids (their own physics and reset, the
# crosshair overlay; the camera at its extremes)


def reach_states(env, gen, dist=0.8, seed=7):
    """States from a reset with agent i ``dist`` from its kit i mod E, at
    a uniform yaw facing it (pickup's probe reaches it where no wall is in
    the way)."""
    state, _ = env.reset(seed=seed)
    n = env.num_envs
    yaw = (torch.rand(n, generator=gen).to(env.device) * 2.0 - 1.0) * math.pi
    slot = torch.arange(n, device=env.device) % state.ent_pos.shape[1]
    kit = state.ent_pos[torch.arange(n, device=env.device), slot]
    # forward is (cos d, 0, -sin d)
    pos = torch.stack([kit[:, 0] - dist * torch.cos(yaw), torch.zeros_like(yaw),
                       kit[:, 2] + dist * torch.sin(yaw)], dim=1)
    return state.replace(pos=pos, dir=yaw)


def check_place_one(label, args, kwargs):
    """place_one kernel vs _place_one: positions and directions equal, env
    for env; returns (max abs difference (0), each env's first passing
    try in the plain version, ``budget`` where all failed)."""
    from miniworld_tpu_torch.ops import place as place_ops

    k_out = place_ops.place_one(*args, **kwargs)
    *p_out, first = place_ops._place_one(*args, **kwargs)
    n = args[0].shape[0]
    budget = kwargs.get("budget", 16)
    differ = torch.zeros(n, dtype=torch.bool, device=args[0].device)
    err = 0.0
    for a, b in zip(k_out, p_out):
        differ |= (a != b).reshape(n, -1).any(dim=1)
        err = max(err, float((a - b).abs().max()))
    say("kernel-vs-plain", kernel="place_one", case=f"{label} B={n} O={args[12].shape[1]} "
        f"budget={budget}", envs_differ=int(differ.sum()), max_abs_err=f"{err:.3e}",
        envs_exhausted=f"{float((first == budget).float().mean()):.3f}",
        tries_per_env=f"{float(torch.clamp(first + 1, max=budget).float().mean()):.3f}")
    if bool(differ.any()):
        raise AssertionError(f"place_one ({label}): {int(differ.sum())} envs differ")
    return err, first


def place_one_work(args, kwargs, first):
    """(bytes, float operations) of one place_one launch on these inputs,
    counting what its outputs depend on: the env's room CDF (R
    multiply-adds), then each try up to the first pass (all ``budget``
    and the fallback where none passes): a room draw by bisection where
    the rule does not fix the room (2 ceil(log2(R + 1))), bbox and
    position 10, outline 4V, walls 22 per segment, 8 per live obstacle;
    the direction 3. Bytes: the per-env inputs (seed, layout, rule row,
    radius, obstacles) and the bank's room tensors read once, position
    and direction written once."""
    seed, bank, _, rule_room = args[:4]
    xz, r_obs, mask = args[10:13]
    n, n_obs = mask.shape
    budget = kwargs.get("budget", 16)
    R = bank.room_mask.shape[1]
    V, ns = bank.room_outline.shape[2], bank.room_segs.shape[3]
    room_bytes = sum(t.numel() * t.element_size() for t in [
        bank.room_mask, bank.room_area, bank.room_aabb, bank.room_outline,
        bank.room_norms, bank.room_vmask, bank.room_segs])
    nbytes = n * (4 + 4 + 44 + 4 + n_obs * 13) + room_bytes + n * 16
    draw = (rule_room < 0).long() * 2 * math.ceil(math.log2(R + 1))
    per_try = draw + 10 + 4 * V + 22 * ns + 8 * mask.long().sum(1)
    found = first < budget
    tries = torch.where(found, first + 1, torch.full_like(first, budget))
    fallback = torch.where(found, torch.zeros_like(first), 2 * draw + 18)
    return nbytes, int((tries * per_try + fallback + 3).sum()) + 2 * R * n


# ---------------------------------------------------------------------------
# the mesh entities' world-space rows (csrc/mesh_rows.cu)

# float operations a mesh row takes in the kernel: su (divide, max),
# cos, sin, -sin; the vertices' 3 rotations (5 a component) scaled and
# moved (63); a1, a2 rotated, scaled, dotted with pos and subtracted
# (48), 1 / su (2); the normal's rotation (15); the tint (3); the slot's
# rint and test (2)
MESH_ROW_OPS = 138


def mesh_rows_work(bank, state, n_rows):
    """(bytes, operations) of the mesh rows of ``state``: the outputs
    written once (verts9 36, attrs 64 and valid 1 byte a row), the inputs
    read once (the prototype rows of the (layout, prototype) pairs in
    use, 100 bytes and a mask byte each; each entity's 37 bytes of state;
    the layout ids) and MESH_ROW_OPS a row."""
    b, e = state.ent_proto.shape
    n_proto, m = bank.proto_mesh.shape[1:3]
    pairs = torch.unique(state.layout_id.long()[:, None] * n_proto
                         + state.ent_proto.long()).numel()
    nbytes = (b * n_rows * (36 + 64 + 1) + pairs * m * 101 + b * e * 37
              + state.layout_id.numel() * state.layout_id.element_size())
    return nbytes, b * n_rows * MESH_ROW_OPS


@contextlib.contextmanager
def plain_mesh_rows():
    """Inside the block the render builds the mesh rows with their plain
    version (the torch chain that the mesh_rows kernel replaced); every
    other stage still launches its kernel."""
    from miniworld_tpu_torch.render import raycast as rc

    kernel = rc.entity_mesh_rows
    rc.entity_mesh_rows = lambda bank, state, fourier=True, use_kernels=True: (
        rc.entity_mesh_rows_plain(bank, state, fourier))
    try:
        yield
    finally:
        rc.entity_mesh_rows = kernel


def phase_profile_plain_rows(env):
    """[profile] of the env's rollout with the mesh rows' plain version in
    place of their kernel, beside the breakdown's own profile: device
    events and busy ms a step without and with the kernel."""
    state, _ = env.reset(seed=0)
    with plain_mesh_rows():
        phase_profile(env, state, path="mesh_rows=plain")


def mesh_states(env, gen, seed=7):
    """A reset's states with about a fifth of the entities dead and every
    entity's yaw drawn from [-4 pi, 4 pi] (the trig's range reduction
    beyond one turn)."""
    state, _ = env.reset(seed=seed)
    shape = state.ent_alive.shape
    alive = state.ent_alive & (torch.rand(shape, generator=gen) > 0.2).to(env.device)
    yaw = ((torch.rand(shape, generator=gen) * 2.0 - 1.0) * (4.0 * math.pi)).to(env.device)
    return state.replace(ent_alive=alive, ent_dir=yaw)


def phase_mesh_rows(cases):
    """[kernel-vs-plain] kernel=entity_mesh_rows: the mesh_rows kernel
    against entity_mesh_rows_plain on the card, verts9, attrs and valid
    bit for bit, for each (label, env, fourier) at the env's batch (its
    mesh_states), and with the layout ids as int64; each case timed with
    its plain version (CUDA events), the kernel alone (torch.profiler)
    and its bound. Returns (max abs error, {label: (ms, plain ms, device
    ms)}, {label: work})."""
    from miniworld_tpu_torch.render import raycast as rc

    gen = torch.Generator().manual_seed(747)
    err, timings, work = 0.0, {}, {}
    for label, env, fourier in cases:
        bank, state = env._bank, mesh_states(env, gen)
        got = rc.entity_mesh_rows(bank, state, fourier)
        want = rc.entity_mesh_rows_plain(bank, state, fourier)
        got64 = rc.entity_mesh_rows(bank, state.replace(layout_id=state.layout_id.long()),
                                    fourier)
        differ = [int((a != b).reshape(a.shape[0], -1).any(1).sum()) for a, b in zip(got, want)]
        same64 = all(torch.equal(a, b) for a, b in zip(got64, got))
        err = max(err, *(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)))
        n_rows, live = got[0].shape[2], int(want[2].sum())
        case = (f"{env.spec.gym_id} B={env.num_envs} E*M={n_rows} "
                f"{'fourier' if fourier else 'nearest'}")
        say("kernel-vs-plain", kernel="entity_mesh_rows", case=case, live_rows=live,
            dead_or_pad_rows=want[2].numel() - live, envs_differ_verts=differ[0],
            envs_differ_attrs=differ[1], envs_differ_valid=differ[2],
            int64_layout_equal=same64, exact=not any(differ))
        if any(differ) or not same64 or not 0 < live < want[2].numel():
            raise AssertionError(f"entity_mesh_rows {case}: kernel differs from plain in "
                                 f"{differ} envs (int64 layout ids equal: {same64}), "
                                 f"{live} live rows")
        timings[label] = (
            cuda_ms(lambda: rc.entity_mesh_rows(bank, state, fourier), 50),
            cuda_ms(lambda: rc.entity_mesh_rows_plain(bank, state, fourier), 20),
            kernel_ms(lambda: rc.entity_mesh_rows(bank, state, fourier), 20, "mesh_rows_kernel"))
        work[label] = mesh_rows_work(bank, state, n_rows)
        ms, plain_ms, dev_ms = timings[label]
        say("kernel-time", kernel="entity_mesh_rows", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            device_ms=fmt_ms(dev_ms), bound_ms=f"{bound(*work[label])[0]:.4f}",
            bound_by=bound(*work[label])[1], library_ms="none", shapes=case)
    return err, timings, work


def phase_collecthealth(health, maze, rates):
    """CollectHealth at B=1024, 80x60: its render stages against their
    plain versions with every env facing a kit (tri_pass with the 18
    kits' 864 mesh rows in its launch, on every pixel), timed, the torch
    gather of the mesh rows timed beside them; place_one against
    _place_one env for env on a step's inputs (carrying varied), with the
    kits' radii scaled until most envs exhaust the budget, with budgets
    0, 31 and 40, and on the 8x8 procgen Maze's agent row (its gated
    walls) against place_all's agent; a pickup step of envs facing their
    kits through the kernels and through the plain versions, states
    equal, kits respawned; then the main path, a rollout through the
    kernels (place_one every step) against the plain path, exactly, with
    its breakdown and profile. Returns ({kernel: max abs error}, timings,
    work, the main path's launches)."""
    from miniworld_tpu_torch.ops import place as place_ops
    from miniworld_tpu_torch.ops.rng import key_data
    from miniworld_tpu_torch.render import raycast as rc

    gen = torch.Generator().manual_seed(1818)
    size = health.spec.size
    state = facing_states(health, gen, (0.5, 0.5), (size - 0.5, size - 0.5))
    cam, tri, _, epi = stage_inputs(health, state)
    ent = None  # 18 medkit meshes, no analytic entity
    rows9, row_attrs, valid = rc.entity_mesh_rows(health._bank, state)
    n_rows = rows9.shape[2]
    if n_rows != 864 or health._shapes_present[0] or health._shapes_present[1]:
        raise AssertionError(f"CollectHealth: {n_rows} mesh rows, shapes "
                             f"{health._shapes_present}")
    timings = {}
    pick_device_ms = DEVICE_MS.get(("tri_pass", "mesh"))  # PickupObjects', kept
    errs, outs = run_stage_checks(
        tri, ent, epi, f"collecthealth B={health.num_envs} HW={W * H} S={tri[0].shape[2]} "
        f"E*M={n_rows}", timings, mesh=(rows9, row_attrs))
    timings["tri_pass_device"] = DEVICE_MS[("tri_pass", "mesh")]
    DEVICE_MS[("tri_pass", "mesh")] = pick_device_ms
    tile = rc.tri_pass_tile()[:2]
    stats = tri_cull_stats(tri, tile=tile)
    m_stats = tri_cull_stats(tri, tile=tile, mesh_rows9=rows9)
    say("tri-cull", env=HEALTH_ID, B=health.num_envs, mesh_rows="yes",
        **cull_fields(m_stats, tile, n_rows))
    work = stage_work(health, state, tri, ent, outs, stats["hit_pairs"],
                      mesh=(rows9, m_stats["hit_pairs"]))
    mesh_t = rc.entity_mesh_pass_plain(rows9, row_attrs, cam)[0]
    # the mesh rows: their kernel, and beside it the plain version (the
    # torch chain of some 150 launches that the kernel replaced)
    rows_ms = cuda_ms(lambda: rc.entity_mesh_rows(health._bank, state), 20)
    rows_plain_ms = cuda_ms(lambda: rc.entity_mesh_rows_plain(health._bank, state), 20)
    rows_bytes = rows9.numel() * 4 + row_attrs.numel() * 4 + valid.numel()
    say("health-scene", px_hit=f"{float(torch.isfinite(outs[0]).float().mean()):.3f}",
        px_mesh_hit=f"{float(torch.isfinite(mesh_t).float().mean()):.4f}",
        live_mesh_rows=int(valid.sum()), tri_pass_smem_bytes=(tri[0].shape[2] + n_rows) * 52,
        mesh_rows_ms=f"{rows_ms:.4f}", mesh_rows_plain_ms=f"{rows_plain_ms:.4f}",
        mesh_rows_bytes_written=rows_bytes,
        mesh_rows_bound_ms=f"{bound(*mesh_rows_work(health._bank, state, n_rows))[0]:.4f}")
    timings["entity_mesh_rows"] = rows_ms

    # place_one: a step's inputs, with carrying varied so that the rule
    # rows and the carried kit's mask vary
    n = health.num_envs
    carrying = torch.randint(-1, health.num_ent_slots, (n,), generator=gen).to(torch.int32)
    pstate = state.replace(carrying=carrying.to(health.device))
    acts = health.sample_actions(key_data(12, health.device))
    args, kwargs = capture_place("place_one", lambda: health._step_batch(pstate, acts))
    err, first = check_place_one(HEALTH_ID, args, kwargs)
    timings["place_one"] = (
        cuda_ms(lambda: place_ops.place_one(*args, **kwargs), 50),
        cuda_ms(lambda: place_ops.place_one_plain(*args, **kwargs), 5, PLAIN_WARMUP),
        kernel_ms(lambda: place_ops.place_one(*args, **kwargs), 50, "place_one_kernel"))
    work["place_one"] = place_one_work(args, kwargs, first)
    for scale in (2.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0):
        big = args[:9] + (args[9] * scale,) + args[10:]
        first = place_ops._place_one(*big, **kwargs)[2]
        exhausted = float((first == kwargs.get("budget", 16)).float().mean())
        if exhausted >= 0.5:
            break
    if exhausted < 0.5:
        raise AssertionError(f"place_one: only {exhausted:.3f} of the envs exhaust the budget")
    err = max(err, check_place_one(f"{HEALTH_ID} radius x{scale}", big, kwargs)[0])
    for budget in (0, 31, 40):
        for label, a in (("", args), (f" radius x{scale}", big)):
            err = max(err, check_place_one(f"{HEALTH_ID}{label} lane rounds", a,
                                           {**kwargs, "budget": budget})[0])
    # the Maze's agent row against the kits place_all put there: place_one
    # with the maze's room weights and gated walls gives place_all's agent
    m_args, m_kwargs = capture_place_args(maze, 13)
    seeds, bank, layout_id, rules, radius, slot_mask = m_args
    e = slot_mask.shape[1]
    ent_pos, _, agent_pos, agent_dir = place_ops.place_all(*m_args, **m_kwargs)
    one_args = (seeds[:, e], bank, layout_id,
                *(rules[name][:, e] for name in place_ops.RULE_FIELDS), radius[:, e],
                ent_pos[:, :, [0, 2]].contiguous(), radius[:, :e].contiguous(), slot_mask)
    err = max(err, check_place_one(f"{MAZE_ID} procgen agent row", one_args, m_kwargs)[0])
    pos, d = place_ops.place_one(*one_args, **m_kwargs)
    if not (torch.equal(pos, agent_pos) and torch.equal(d, agent_dir)):
        raise AssertionError("place_one on the maze's agent row differs from place_all's agent")
    errs["place_one"] = err

    # a pickup step of envs facing their kits: kernels vs plain, states
    # equal, the kits respawned
    rstate = reach_states(health, gen)
    pick = torch.zeros((n, 6), device=health.device)
    pick[:, 4] = 1.0
    k_state, k_rew, k_done, _ = health._step_batch(rstate, pick)
    health.use_kernels = False
    try:
        p_state, p_rew, p_done, _ = health._step_batch(rstate, pick)
    finally:
        health.use_kernels = True
    differ = [name for name, v in k_state.tensors().items()
              if not torch.equal(v, p_state.tensors()[name])]
    respawned = int((k_state.task["health"] == 100).sum())
    moved = int((k_state.ent_pos != rstate.ent_pos).any(-1).any(-1).sum())
    say("health-respawn", B=n, envs_respawned=respawned, envs_with_a_kit_moved=moved,
        kernel_vs_plain_fields_differ=differ or "none")
    if differ or not (torch.equal(k_rew, p_rew) and torch.equal(k_done, p_done)):
        raise AssertionError(f"CollectHealth pickup step: kernels and plain differ on {differ}")
    if respawned < n // 4 or moved != respawned:
        raise AssertionError(f"CollectHealth: {respawned} respawns, {moved} kits moved")

    # the main path through the kernels, then (its plain path taking ~1 s
    # a step) a shorter rollout through the kernels against the plain path
    rate, outs, obs, launches, _ = rollouts(health, "kernels", SHORT_HORIZON, TRIALS)
    check_rollout(health, outs, obs, launches, SHORT_HORIZON, TRIALS, path_kernels(health))
    rates[f"collecthealth_b{n}"] = (rate, None)
    rates[f"collecthealth_b{n}_h{PLAIN_HORIZON}"] = kernel_and_plain(
        health, PLAIN_HORIZON, TRIALS, path_kernels(health), exact=True)[:2]
    phase_breakdown(health, render_iters=5, plain_render_iters=0)
    phase_profile_plain_rows(health)
    return errs, timings, work, launches


def overlay_time(env):
    """(ms, bound ms) of the crosshair overlay on the env's (B, H, W, 3)
    frame: CUDA events over 50 calls; the bound reads the frame and the
    (H, W) mask and writes the frame."""
    from miniworld_tpu_torch.envs.cameracontrol import draw_crosshair

    rgb = env.render(env.reset(seed=1)[0])[0]
    ms = cuda_ms(lambda: draw_crosshair(rgb), 50)
    return ms, bound(2 * rgb.numel() + rgb.shape[1] * rgb.shape[2], 0)[0]


def phase_camera(cam, click, rates):
    """The camera ids at B=1024, 80x60: each rollout through the kernels,
    the crosshair red on every observation, then a PLAIN_HORIZON-step
    rollout against the plain path (rewards and dones equal, checksums
    exactly); the overlay timed. Returns ({label: launches}, overlay (ms,
    bound ms))."""
    from miniworld_tpu_torch.envs.cameracontrol import crosshair_mask

    launches = {}
    for env in (cam, click):
        rate, outs, obs, launches[env.spec.name], _ = rollouts(env, "kernels", SHORT_HORIZON,
                                                               TRIALS)
        check_rollout(env, outs, obs, launches[env.spec.name], SHORT_HORIZON, TRIALS,
                      path_kernels(env))
        mask = crosshair_mask(H, W, torch.device(env.device))[:, :, 0]
        red = torch.tensor([255, 0, 0], dtype=torch.uint8, device=env.device)
        if not bool((obs[0][:, mask] == red).all()):
            raise AssertionError(f"{env.spec.gym_id}: the crosshair is not red on every frame")
        rates[env.spec.name.lower() + f"_b{env.num_envs}"] = (rate, None)
        rates[env.spec.name.lower() + f"_b{env.num_envs}_h{PLAIN_HORIZON}"] = kernel_and_plain(
            env, PLAIN_HORIZON, TRIALS, path_kernels(env), exact=True)[:2]
    ms, bound_ms = overlay_time(cam)
    say("overlay", name="crosshair", env=CAM_ID, B=cam.num_envs, ms=f"{ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by="bytes", route="torch.where, no kernel")
    return launches, (ms, bound_ms)


def extreme_states(env, seed=5):
    """States from a reset of CameraControl (each camera 0.1 m from a wall)
    at its extremes: fov 20 or 90 and pitch +-89 in turn over the envs,
    each combination facing its own wall (yaw + pi), the room (as reset),
    and 45 degrees either side."""
    state, _ = env.reset(seed=seed)
    n = env.num_envs
    i = torch.arange(n, device=env.device)
    fov = torch.where(i % 2 == 0, 20.0, 90.0)
    pitch = torch.where((i // 2) % 2 == 0, 89.0, -89.0)
    turn = torch.tensor([math.pi, 0.0, math.pi / 4, -math.pi / 4], device=env.device)[(i // 4) % 4]
    return state.replace(dir=state.dir + turn, cam_fov_y=fov, cam_pitch=pitch)


def one_chunk_route(env, state):
    """(tri_args, mesh, override) of a one-chunk render of ``state`` at the
    env's samples, its mesh rows in the launch (no schedule, no
    override)."""
    from miniworld_tpu_torch.render import raycast as rc

    ss = env.supersample
    cam = rc.camera_grid(state, env.obs_width * ss, env.obs_height * ss)
    bank = env._bank
    mesh = rc.entity_mesh_rows(bank, state)[:2] if env._shapes_present[2] else None
    return (bank.tri_verts9, bank.tri_attr, state.layout_id, cam, env._all_quads), mesh, None


def phase_camera_extremes(make_env):
    """tri_pass, entity_pass and the epilogue (SS=1 and SS=2) against their
    plain versions on every pixel at CameraControl's extremes, B_EXT envs
    (extreme_states). Returns {kernel: max abs error}."""
    errs = {"tri_pass": 0.0, "entity_pass": 0.0}
    for ss in (1, 2):
        env = make_env(CAM_ID, B_EXT, supersample=ss)
        if env.plan["nc"] != 1:
            raise AssertionError(f"CameraControl plans {env.plan}")
        state = extreme_states(env)
        label = f"cameracontrol extremes ss={ss}"
        tri, mesh, _ = one_chunk_route(env, state)
        errs["tri_pass"] = max(errs["tri_pass"], check_tri_pass(
            tri, f"{label} B={B_EXT} samples={tri[3].width}x{tri[3].height}", mesh=mesh)[2])
        errs["entity_pass"] = max(errs["entity_pass"],
                                  check_render_stages(env, state, label, route=one_chunk_route))
    return errs


# ---------------------------------------------------------------------------
# the top view (view="top": tri_pass_ortho, topview_epilogue) and the
# visibility query (visible_ents)


def ortho_scan_rows(st, layout_id, wall_open):
    """(B, HW) i32: the rows the tri_pass_ortho kernel scans at each pixel,
    the live rows (``row_live`` in the env) of its tile's list."""
    from miniworld_tpu_torch.render import topview as tv

    b, w, h = layout_id.shape[0], st.width, st.height
    n_tx, n_t = -(-w // tv.TILE_W), st.tile_off.shape[1] - 1
    lid = layout_id.long()
    live = tv.row_live(st.row_code[lid], wall_open).int()  # (B, Sc)
    off = st.tile_off.long()
    per_tile = torch.zeros((b, n_t), dtype=torch.int32, device=live.device)
    for l in torch.unique(lid).tolist():
        envs = torch.nonzero(lid == l)[:, 0]
        lst = st.tile_rows[off[l, 0]:off[l, n_t]].long()
        tile_of = torch.repeat_interleave(torch.arange(n_t, device=lst.device),
                                          off[l, 1:] - off[l, :-1])
        per_tile[envs] = per_tile[envs].index_add_(1, tile_of, live[envs][:, lst])
    y, x = torch.div(torch.arange(w * h, device=lid.device), w, rounding_mode="floor"), \
        torch.arange(w * h, device=lid.device) % w
    return per_tile[:, (y // tv.TILE_H) * n_tx + x // tv.TILE_W]


def scan_fields(st, layout_id, wall_open):
    """The [topview-stages] line's count of rows a pixel scans."""
    n = ortho_scan_rows(st, layout_id, wall_open).float()
    return {"rows_a_px_mean": f"{float(n.mean()):.3f}", "rows_a_px_max": int(n.max())}


def top_tie_bank(dev, seed=5, S=300):
    """A one-layout bank of S floor prims in [0, 10]^2 at heights 0-2
    (random quads and triangles, some masked) with equal quads at rows 127
    and 128, 180 and 290, 250 and 260 (each pair coplanar, facing up, at
    the same t everywhere: the first must win), and its top_statics at
    W x H: lists of 30-60 rows a tile, so the kernel stages them in more
    than one batch of 32."""
    import types

    from miniworld_tpu_torch.render import topview as tv

    rng = np.random.default_rng(seed)
    verts = np.zeros((S, 3, 3), np.float32)
    for i in range(S):
        x0, z0 = rng.uniform(0, 9, 2)
        sx, sz = rng.uniform(0.3, 3.0, 2)
        y = rng.choice([0.0, 0.5, 1.25, 2.0])
        verts[i] = [[x0, y, z0], [x0, y, z0 + sz], [x0 + sx, y, z0]]
    for a, b, (x0, z0, sx, sz) in ((127, 128, (2, 2, 4, 4)), (180, 290, (6, 1, 3, 3)),
                                   (250, 260, (1, 7, 2, 2))):
        verts[a] = verts[b] = [[x0, 3.0, z0], [x0, 3.0, z0 + sz], [x0 + sx, 3.0, z0]]
    attr = np.zeros((S, 16), np.float32)
    attr[:, 15] = rng.choice([0.0, 1.0], S)
    attr[[127, 128, 180, 290, 250, 260], 15] = 0.0
    mask = rng.random(S) > 0.1
    mask[[127, 128, 180, 290, 250, 260]] = True
    bank = types.SimpleNamespace(
        tri_verts=torch.from_numpy(verts[None]), tri_attr=torch.from_numpy(attr[None]),
        tri_mask=torch.from_numpy(mask[None]), tri_wall_onehot=None,
        extents=torch.tensor([[0.0, 12.0, 0.0, 12.0]]))
    return tv.top_statics(bank, W, H, device=dev)


def top_tie_check(n):
    """tri_pass_ortho against its plain version on the tie bank
    (top_tie_bank) at B = n: t bit for bit, rows equal, the first row of
    every equal pair wins and the second never does."""
    from miniworld_tpu_torch.render import topview as tv

    st = top_tie_bank(DEVICE)
    scan = (st, torch.zeros(n, dtype=torch.int32, device=DEVICE), None)
    t_k, r_k = tv.tri_pass_ortho(*scan)
    t_p, r_p = tv.tri_pass_ortho_plain(*scan)
    n_t = int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum())
    n_row = int((r_k != r_p).sum())
    won = set(torch.unique(r_k).tolist())
    lens = st.tile_off[0, 1:] - st.tile_off[0, :-1]
    say("kernel-vs-plain", kernel="tri_pass_ortho", case=f"tie bank B={n} {W}x{H} "
        f"staged={st.rows.shape[1]} list_max={int(lens.max())}", t_differs_px=n_t,
        row_differs_px=n_row, firsts_won=sorted(won & {127, 180, 250}),
        seconds_won=sorted(won & {128, 290, 260}), **scan_fields(*scan), exact=True)
    if n_t or n_row or not {127, 180, 250} <= won or won & {128, 290, 260} or lens.max() <= 32:
        raise AssertionError(f"tri_pass_ortho tie bank: {n_t} t, {n_row} row pixels differ, "
                             f"rows {sorted(won)} won, lists up to {int(lens.max())}")
    return max(max_abs_diff(t_k, t_p), max_abs_diff(r_k.float(), r_p.float()))


def top_stage_check(label, env, state):
    """The env's top view of ``state``, stage by stage, kernels against
    plain versions on the same inputs: tri_pass_ortho (t bit for bit, the
    winner's row equal), then topview_epilogue on the kernel's hits (u8
    images and depth equal). Returns (the scan's inputs, its outputs, the
    epilogue's arguments, the max abs difference over t, rows, images and
    depth)."""
    from miniworld_tpu_torch.render import cuda_build
    from miniworld_tpu_torch.render import topview as tv

    st, bank = env._top, env._bank
    wall_open = state.wall_open if bank.tri_wall_onehot is not None else None
    scan = (st, state.layout_id, wall_open)
    before = dict(cuda_build.LAUNCHES)
    t_k, r_k = tv.tri_pass_ortho(*scan)
    t_p, r_p = tv.tri_pass_ortho_plain(*scan)
    n_t = int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum())
    n_row = int((r_k != r_p).sum())
    ents, lights, marker = tv.epilogue_inputs(bank, state, env.spec.agent_radius)
    tex_map = state.tex_map if env.tex_mode == "nearest" else None
    epi = (t_k, r_k, ents, bank.tri_attr, state.layout_id, st, env._atlas, lights, marker,
           env.fourier_k, env._has_gain, tex_map)
    rgb_k, d_k = tv.topview_epilogue(*epi, table=env._fourier_table)
    rgb_p, d_p = tv.topview_epilogue_plain(*epi)
    n_rgb = int((rgb_k != rgb_p).any(-1).sum())
    n_depth = int((d_k.view(torch.int32) != d_p.view(torch.int32)).sum())
    err = max(max_abs_diff(t_k, t_p), max_abs_diff(r_k.float(), r_p.float()),
              max_abs_diff(rgb_k, rgb_p), max_abs_diff(d_k, d_p))
    launched = {k: v - before[k] for k, v in cuda_build.LAUNCHES.items() if v > before[k]}
    ent_px = int((torch.isfinite(tv.entity_pass_ortho_plain(
        *tv._pixel_coords(st, state.layout_id.long()), *ents)[0])).sum())
    marker_px = int(((rgb_k[..., 0] == 255) & (rgb_k[..., 1] == 0) & (rgb_k[..., 2] == 0)).sum())
    case = (f"{label} B={env.num_envs} {env.obs_width}x{env.obs_height} tex={env.tex_mode} "
            f"S={bank.tri_mask.shape[1]} "
            f"staged={st.rows.shape[1]} tile_rows={st.tile_rows.numel()}"
            f" layouts={len(torch.unique(state.layout_id))}"
            f"{' gain' if env._has_gain else ''}{' maze' if wall_open is not None else ''}")
    say("kernel-vs-plain", kernel="tri_pass_ortho, topview_epilogue", case=case,
        t_differs_px=n_t, row_differs_px=n_row, rgb_differs_px=n_rgb, depth_differs_px=n_depth,
        max_abs_err=f"{err:.3e}", px_prim=f"{float((r_k >= 0).float().mean()):.3f}",
        entity_px=ent_px, marker_px=marker_px, **scan_fields(*scan), launched=launched,
        exact=True)
    if n_t or n_row or n_rgb or n_depth:
        raise AssertionError(f"top view ({case}): kernels differ from plain on {n_t} t, "
                             f"{n_row} row, {n_rgb} RGB and {n_depth} depth pixels")
    want = {"tri_pass_ortho", "topview_epilogue"} | (
        {"topview_epilogue_nearest"} if tex_map is not None else set())
    if not want <= set(launched) or marker_px == 0 or float((r_k >= 0).float().mean()) < 0.05:
        raise AssertionError(f"top view ({case}): launched {launched}, {marker_px} marker px")
    return scan, (t_k, r_k), epi, err


def top_work(env, scan, outs, epi):
    """(bytes, operations) of the top view's two launches on these inputs,
    each input read once, each output written once. tri_pass_ortho: the
    statics (staged rows, ids, codes, tile lists, grid), layout ids and
    mazes in, t and row (8 bytes) a pixel out; 30 operations per (row,
    pixel) pair that passes the hit test (three 3-term dots 15, offsets
    3, scalings 3, coverage 3, gates 6) and 1 a pixel; under
    "tri_pass_ortho_full_scan" every (bank row, pixel) pair. The
    epilogue: t and row a pixel, each bank row once, the entities,
    lights, marker, grid and texture table (or u8 atlas and tex_map) once,
    7 bytes out a pixel; 60 operations a pixel (uv, lighting, the pack),
    15 for the marker, 10 per (pixel, active entity), and per textured
    pixel 35 a Fourier term (no footprint) or 12 for the nearest texel.
    "topview_epilogue_texels": the texels the kernel computes (a prim of
    a valid slot, no strictly nearer entity), for its issue floor."""
    from miniworld_tpu_torch.render import topview as tv

    st, layout_id, wall_open = scan
    t_k, r_k = outs
    b, hw = layout_id.shape[0], W * H

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    statics = nbytes(st)
    hit_pairs = 0
    for sl in [slice(i, i + 16) for i in range(0, b, 16)]:
        hit_pairs += int(torch.isfinite(tv.ortho_row_t(
            st, layout_id[sl], None if wall_open is None else wall_open[sl])).sum())
    s_bank = env._bank.tri_mask.shape[1]
    scan_bytes = statics + b * 4 + nbytes([wall_open]) + b * hw * 8
    work = {"tri_pass_ortho": (scan_bytes, hit_pairs * 30 + b * hw),
            "tri_pass_ortho_full_scan": (scan_bytes, b * hw * s_bank * 30)}
    ents, atlas, tex_map = epi[2], epi[6], epi[11]
    flags = ents[5]
    n_active = int(((flags & tv.ORTHO_ACTIVE) != 0).sum())
    slot = torch.round(env._bank.tri_attr[layout_id.long()[:, None],
                                          r_k.clamp(min=0).long()][..., 14])
    textured = int(((r_k >= 0) & (slot >= 0)).sum())
    # the texels the kernel computes: a valid slot and no strictly nearer entity
    px, pz = tv._pixel_coords(st, layout_id.long())
    t_ent = tv.entity_pass_ortho_plain(px, pz, *ents)[0]
    n_rows = (env._fourier_table if tex_map is None else atlas).shape[0]
    work["topview_epilogue_texels"] = int(((r_k >= 0) & (slot >= 0) & (slot < n_rows)
                                           & ~(t_ent < t_k)).sum())
    tex_bytes = (nbytes([env._fourier_table]) if tex_map is None
                 else nbytes([atlas, tex_map]))
    per_texel = 12 if tex_map is not None else 35 * env.fourier_k
    work["topview_epilogue"] = (
        b * hw * 8 + nbytes([env._bank.tri_attr]) + nbytes(ents) + nbytes([epi[7], epi[8]])
        + nbytes([st.xs, st.zs]) + tex_bytes + b * hw * 7,
        b * hw * 75 + hw * n_active * 10 + textured * per_texel)
    return work


def phase_topview_stages(cases, maze_top, pick_top):
    """[topview-stages]: top_stage_check on every case, [(label, env)] at
    B_PLAIN (Hallway, PickupObjects' footprints, FourRooms nearest, Sign's
    glyphs with no footprint, the 8x8 procgen Maze's killed rows, the
    MazeS3 bank's 64 layouts mixed among one block's envs), the tie bank
    (top_tie_check), then at the shapes of the PickupObjects top-view
    main path (B=4096, its ball, box and mesh footprints through the
    fused entity loop) and of the Maze 8x8 procgen one (B=8192, 80x60),
    the Maze's checked the same way and timed, each kernel beside its
    plain version on the same inputs, the epilogue beside the issue
    rate's floor for its Fourier terms. Returns (max abs difference,
    {name: (ms, plain ms)}, {name: work}, labels checked)."""
    from miniworld_tpu_torch.render import topview as tv

    gen = torch.Generator().manual_seed(1010)
    errs, checked = [], []
    for label, env in cases + [("pickupobjects", pick_top)]:
        errs.append(top_stage_check(label, env, view_states(env, gen))[3])
        checked.append(label if env.num_envs == B_PLAIN else f"{label} B={env.num_envs}")
    errs.append(top_tie_check(B_PLAIN))
    checked.append("tie bank (tri_pass_ortho)")
    state = random_maze_states(maze_top, gen, seed=11)
    scan, outs, epi, err = top_stage_check("maze8x8-procgen", maze_top, state)
    errs.append(err)
    checked.append(f"maze8x8-procgen B={B_MAZE}")
    timings = {
        "tri_pass_ortho": (cuda_ms(lambda: tv.tri_pass_ortho(*scan), 50),
                           cuda_ms(lambda: tv.tri_pass_ortho_plain(*scan), 1, warmup_calls=0)),
        "topview_epilogue": (
            cuda_ms(lambda: tv.topview_epilogue(*epi, table=maze_top._fourier_table), 50),
            cuda_ms(lambda: tv.topview_epilogue_plain(*epi), 1, warmup_calls=0)),
    }
    work = top_work(maze_top, scan, outs, epi)
    shapes = (f"{MAZE_ID} procgen view=top B={B_MAZE} HW={W * H} S={scan[0].row_id.shape[1]} "
              f"staged of {maze_top._bank.tri_mask.shape[1]}")
    per_term = sass_term_instructions(maze_top.fourier_k, False, "topview_epilogue")
    work["topview_epilogue_floor"] = (
        issue_floor_ms(work["topview_epilogue_texels"] * maze_top.fourier_k, per_term), per_term)
    for name, (ms, plain) in timings.items():
        extra = ({"bound_full_scan_ms": f"{bound(*work['tri_pass_ortho_full_scan'])[0]:.4f}"}
                 if name == "tri_pass_ortho" else
                 {"issue_floor_ms": fmt_ms(work["topview_epilogue_floor"][0]),
                  "instructions_a_term": per_term,
                  "texels": work["topview_epilogue_texels"]})
        say("kernel-time", kernel=name, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
            bound_ms=f"{bound(*work[name])[0]:.4f}", bound_by=bound(*work[name])[1], **extra,
            shapes=shapes)
    return max(errs), timings, work, checked


def vis_work(args, n_live):
    """((bytes, 0), full-scan (bytes, operations)) of a visible_ents launch
    on ``args`` (its plain version's arguments). The bound: the bytes the
    result needs, the layouts' room rows and codes once, each env's
    camera, layout id, walls and entities, and the (B, E) flags. Beside
    it the full scan's operations: 25 per (live room row, pixel) pair
    (three 3-term dots 15, the reciprocal and t 2, coverage 3, gates 5)
    and 40 a staged live row, 30 per (alive entity, pixel) pair (six
    subtractions, six divisions, the slab min / max and the gates).
    ``n_live``: the live room rows summed over the envs."""
    st, layout_id, wall_open, cam, ent_pos, ent_alive = args
    b, hw = layout_id.shape[0], cam.width * cam.height
    nbytes = sum(t.numel() * t.element_size() for t in (*st, layout_id, wall_open, ent_pos,
                                                         ent_alive) if t is not None)
    nbytes += b * 14 * 4 + (cam.width + cam.height) * 4 + ent_alive.numel()
    return (nbytes, 0), (nbytes, n_live * (hw * 25 + 40) + int(ent_alive.sum()) * hw * 30)


def head_args(args, n):
    """visible_ents' arguments for the first ``n`` envs of ``args``."""
    from miniworld_tpu_torch.render.raycast import Camera

    st, layout_id, wall_open, cam, ent_pos, ent_alive = args
    cam = Camera(*(x[:n] for x in cam[:6]), cam.xbase, cam.ybase)
    return (st, layout_id[:n], None if wall_open is None else wall_open[:n], cam, ent_pos[:n],
            ent_alive[:n])


def vis_args(env, state):
    """visible_ents' arguments for ``state``, as env.visible_ents makes them."""
    from miniworld_tpu_torch.render.raycast import camera_grid

    wall_open = state.wall_open if env._bank.tri_wall_onehot is not None else None
    return (env._vis, state.layout_id, wall_open, camera_grid(state, W, H), state.ent_pos,
            state.ent_alive)


def behind_wall_states(env, gen, near, behind, seed=7):
    """States of the procgen maze with each agent facing a closed wall of a
    random cell (its maze's, or the border), its eye ``near`` (lo, hi)
    metres in front of the wall's face, pitch within 20 degrees, and its
    entity slot 0, the query box's centre at eye height, ``behind`` (lo,
    hi) metres behind the face and 0.6 or more from the wall's ends: every
    ray to the box crosses the wall, so no box is visible, and close to
    the wall the box covers much of the view."""
    from miniworld_tpu_torch.ops import mazegen

    spec = env.spec
    state, _ = env.reset(seed=seed)
    n, dev = env.num_envs, env.device
    nbr_cell, nbr_wall = (torch.from_numpy(t).long() for t in mazegen.neighbor_tables(
        spec.num_rows, spec.num_cols))
    wall_open = state.wall_open.cpu()
    shut = (nbr_wall[None] < 0) | (torch.gather(
        wall_open, 1, nbr_wall.clamp(min=0).reshape(1, -1).expand(n, -1)).reshape(
        n, *nbr_wall.shape) < 0.5)  # (B, N, 4): [+x, -x, +z, -z]
    pick = torch.multinomial(shut.reshape(n, -1).float(), 1, generator=gen)[:, 0]
    cell, k = pick // 4, pick % 4
    ci, cj = cell // spec.num_cols, cell % spec.num_cols
    pitch, size = spec.room_size + spec.gap_size, spec.room_size
    axis_x = k < 2  # the wall's normal along x
    sign = torch.where(k % 2 == 0, 1.0, -1.0)  # +x / +z: the face at the cell's high end
    lo_axis = torch.where(axis_x, cj, ci).float() * pitch
    lo_other = torch.where(axis_x, ci, cj).float() * pitch
    face = lo_axis + torch.where(sign > 0, size, 0.0)
    u = torch.rand((n, 5), generator=gen)
    lateral = lo_other + 0.6 + (size - 1.2) * u[:, 0]
    disp = state.cam_fwd_disp.cpu()
    a = near[0] + (near[1] - near[0]) * u[:, 1]
    along = face - sign * (a + disp)
    box_along = face + sign * (behind[0] + (behind[1] - behind[0]) * u[:, 2] + 0.1)
    box_lateral = lateral + 0.6 * (u[:, 3] - 0.5)
    zero = torch.zeros(n)
    pos = torch.where(axis_x[:, None], torch.stack([along, zero, lateral], 1),
                      torch.stack([lateral, zero, along], 1))
    ent = state.ent_pos.cpu().clone()
    box_y = state.cam_height.cpu() - 0.1
    ent[:, 0] = torch.where(axis_x[:, None], torch.stack([box_along, box_y, box_lateral], 1),
                            torch.stack([box_lateral, box_y, box_along], 1))
    yaw = torch.tensor([0.0, math.pi, -math.pi / 2, math.pi / 2])[k]
    return state.replace(pos=pos.to(dev), dir=yaw.to(dev), ent_pos=ent.to(dev),
                         cam_pitch=(40.0 * (u[:, 4] - 0.5)).to(dev))


def close_states(env, gen, dist, seed=7):
    """PickupObjects states with agent i ``dist`` (lo, hi) metres from its
    entity slot i mod E (eye to the box's centre, raised to eye height),
    on the room's centre side of it (within 45 degrees) and facing it:
    the box covers much of the view and nothing hides it."""
    state, _ = env.reset(seed=seed)
    n, dev = env.num_envs, env.device
    e_n = state.ent_pos.shape[1]
    idx = torch.arange(n) % e_n
    ent = state.ent_pos.cpu().clone()
    target = ent[torch.arange(n), idx]
    u = torch.rand((n, 2), generator=gen)
    outward = torch.atan2(-(target[:, 2] - 6.0), target[:, 0] - 6.0)  # centre -> entity
    bearing = outward + (u[:, 0] - 0.5) * (math.pi / 2)
    r = dist[0] + (dist[1] - dist[0]) * u[:, 1]
    fwd = torch.stack([torch.cos(bearing), torch.zeros(n), -torch.sin(bearing)], 1)
    pos = target - (r + state.cam_fwd_disp.cpu())[:, None] * fwd
    pos[:, 1] = 0.0
    ent[torch.arange(n), idx, 1] = state.cam_height.cpu() - 0.1
    return state.replace(pos=pos.to(dev), dir=bearing.to(dev), ent_pos=ent.to(dev),
                         cam_pitch=torch.zeros(n, device=dev))


def eye_states(env, gen, seed=7):
    """PickupObjects states from a reset at random yaw and pitch (+-60
    degrees) with entity slot 0 at the agent's own position, slot 1's box
    astride the near plane (its centre 0.02-0.16 ahead of the eye, 0.05
    aside at most) and slot 2's box around the eye (the eye inside it,
    never visible)."""
    from miniworld_tpu_torch.ops import geom

    state, _ = env.reset(seed=seed)
    n, dev = env.num_envs, env.device
    u = torch.rand((n, 7), generator=gen).to(dev)
    state = state.replace(dir=(2.0 * u[:, 0] - 1.0) * math.pi, cam_pitch=120.0 * (u[:, 1] - 0.5))
    eye = geom.cam_position(state.pos, state.dir, state.cam_height, state.cam_fwd_disp)
    fwd, _, right = geom.cam_basis(state.dir, state.cam_pitch)
    down = torch.tensor([0.0, 0.1, 0.0], device=dev)
    ent = state.ent_pos.clone()
    ent[:, 0] = state.pos
    ent[:, 1] = eye + (0.02 + 0.14 * u[:, 2:3]) * fwd + 0.1 * (u[:, 3:4] - 0.5) * right - down
    ent[:, 2] = eye - down + 0.1 * (u[:, 4:7] - 0.5)
    return state.replace(ent_pos=ent)


def vis_stats(args):
    """The visible_ents kernel's counts on ``args``: envs that staged their
    rows, (tile, entity) pairs the cull kept, slab tests, occlusion scans,
    rows those scans tested, rows staged."""
    from miniworld_tpu_torch.render import visibility as vis

    stats = torch.zeros(vis.N_STATS, dtype=torch.int64, device=args[1].device)
    vis.visible_ents(*args, stats=stats)
    return dict(zip(("envs_staged", "pairs_kept", "slab_tests", "rows_scans", "rows_scanned",
                     "rows_staged"), (int(x) for x in stats.cpu())))


def phase_visible_ents(cases, steps=5):
    """[visible-ents]: MiniWorldVec.visible_ents on each (label, env, args,
    check, path) case: the kernel against its plain version on the same
    arguments, the mask equal on every (env, entity), ``check(mask,
    alive)`` the visible count the case expects, both timed (the kernel
    also alone under torch.profiler), and a [vis-cull] line of the
    kernel's counts. The cases: PickupObjects B=4096 facing its entities
    and the 8x8 procgen Maze B=8192 in random cells (the main paths'
    shapes), then at B=1024 boxes close to the eye, behind closed walls,
    astride the near plane and at the agent's own position, and a
    multi-room bank without walls to kill. Where ``path``, the query's
    own path: ``steps`` random steps each followed by env.visible_ents,
    counts set to 0 before and read after. Returns (max abs difference,
    {label: (ms, plain ms, device ms)}, {label: (work, full-scan work)},
    {label: launches of the path})."""
    from miniworld_tpu_torch.ops.rng import key_data
    from miniworld_tpu_torch.render import cuda_build
    from miniworld_tpu_torch.render import visibility as vis
    from miniworld_tpu_torch.render.topview import row_live

    errs, timings, work, launches = [], {}, {}, {}
    for label, env, args, check, path in cases:
        b = args[1].shape[0]
        got = vis.visible_ents(*args)
        want = vis.visible_ents_plain(*args)
        n_diff = int((got != want).sum())
        errs.append(float(n_diff))
        live = row_live(args[0].row_code[args[1].long()], args[2])
        work[label] = vis_work(args, int(live.sum()))
        timings[label] = (cuda_ms(lambda: vis.visible_ents(*args), 20),
                          cuda_ms(lambda: vis.visible_ents_plain(*args), 1, warmup_calls=0),
                          kernel_ms(lambda: vis.visible_ents(*args), 20, "visible_ents_kernel"))
        n_vis, n_alive = int(want.sum()), int(args[5].sum())
        say("kernel-vs-plain", kernel="visible_ents", case=f"{label} B={b} {W}x{H} "
            f"Sr={args[0].rows.shape[1]} E={args[5].shape[1]}",
            mask_differs=n_diff, visible=n_vis, alive=n_alive,
            live_room_rows=int(live.sum()), exact=True)
        counts = vis_stats(args)
        say("vis-cull", case=f"{label} B={b}", **counts)
        say("kernel-time", kernel="visible_ents", ms=f"{timings[label][0]:.4f}",
            device_ms=fmt_ms(timings[label][2]), plain_ms=f"{timings[label][1]:.4f}",
            bound_ms=f"{bound(*work[label][0])[0]:.4f}", bound_by=bound(*work[label][0])[1],
            bound_full_scan_ms=f"{bound(*work[label][1])[0]:.4f}",
            shapes=f"{label} B={b} HW={W * H}")
        if n_diff or not check(want, args[5]) or not counts["rows_scans"]:
            raise AssertionError(f"visible_ents {label}: {n_diff} (env, entity) differ, "
                                 f"{n_vis} of {n_alive} visible, {counts}")
        if not path:
            continue
        # the query's path: a step, then the query, counts read after
        state, _ = env.reset(seed=5)
        acts = env.rollout_actions(key_data(12, env.device), steps)
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        n_vis = 0
        for a in acts:
            state = env._step_batch(state, a)[0]
            n_vis += int(env.visible_ents(state).sum())
        secs = time.perf_counter() - t0
        launches[label] = dict(cuda_build.LAUNCHES)
        say("visible-ents-path", env=label, B=env.num_envs, steps=steps,
            visible_per_step=f"{n_vis / steps:.1f}", ms_per_step=f"{secs * 1e3 / steps:.3f}",
            launches={k: v for k, v in launches[label].items() if v})
        if launches[label]["visible_ents"] < steps or n_vis == 0:
            raise AssertionError(f"visible_ents path {label}: {launches[label]}, {n_vis} visible")
    return max(errs), timings, work, launches


def vis_cases(pick, maze, three, gen):
    """phase_visible_ents' cases (label, env, args, check, path); the
    B=1024 ones are the first B envs of the B_PICK and B_MAZE states."""

    def some(mask, alive):  # some visible, some not
        return 0 < int(mask.sum()) < int(alive.sum())

    def target_seen(mask, alive):  # every env sees its slot i mod E
        idx = torch.arange(mask.shape[0], device=mask.device) % mask.shape[1]
        return bool(mask[torch.arange(mask.shape[0], device=mask.device), idx].all())

    def eye_checks(mask, alive):  # the eye inside slot 2's box: never visible
        return some(mask, alive) and not bool(mask[:, 2].any())

    return [
        ("pickupobjects", pick,
         vis_args(pick, facing_states(pick, gen, (0.5, 0.5), (11.5, 11.5))), some, True),
        ("maze8x8-procgen", maze, vis_args(maze, random_maze_states(maze, gen, seed=13)), some,
         True),
        ("pickupobjects-close", pick,
         head_args(vis_args(pick, close_states(pick, gen, (0.15, 0.6))), B), target_seen, False),
        ("maze8x8-procgen-behind-wall", maze, head_args(vis_args(
            maze, behind_wall_states(maze, gen, (0.1, 0.6), (0.2, 0.6))), B),
         lambda mask, alive: not bool(mask.any()), False),
        ("pickupobjects-near-eye", pick, head_args(vis_args(pick, eye_states(pick, gen)), B),
         eye_checks, False),
        ("threerooms", three, vis_args(three, view_states(three, gen)), some, False)]


def phase_topview_paths(maze_top, pick_top, make_env, rates):
    """The top-view main paths: the Maze 8x8 procgen one at B=8192 and
    PickupObjects at B=4096, each with its breakdown and profile, then
    Hallway's top view at B_PLAIN against its plain path, exactly.
    Returns {label: launches}."""
    launches = {}
    rate, outs, obs, launches["maze"], _ = rollouts(maze_top, "top", HORIZON, TRIALS)
    check_rollout(maze_top, outs, obs, launches["maze"], HORIZON, TRIALS, path_kernels(maze_top))
    rates["maze8x8_procgen_top_b8192"] = (rate, None)
    phase_breakdown(maze_top, render_iters=5, plain_render_iters=0)
    rate, outs, obs, launches["pick"], _ = rollouts(pick_top, "top", SHORT_HORIZON, TRIALS)
    check_rollout(pick_top, outs, obs, launches["pick"], SHORT_HORIZON, TRIALS,
                  path_kernels(pick_top))
    rates["pickupobjects_top_b4096"] = (rate, None)
    phase_breakdown(pick_top, render_iters=5, plain_render_iters=0)
    env = make_env(ENV_ID, B_PLAIN, view="top")
    rates[f"hallway_top_b{B_PLAIN}"] = kernel_and_plain(
        env, PLAIN_HORIZON, TRIALS, path_kernels(env), exact=True)[:2]
    return launches


# ---------------------------------------------------------------------------
# the main paths


def rollouts(env, label, horizon, trials, warmup=True):
    """Reset, a warm-up rollout, then ``trials`` timed rollouts, each from
    its own key (``key_data(1000 + trial)``); returns
    (env-steps/s, per-trial outs, last obs, kernel launches of the timed
    trials, last state)."""
    from miniworld_tpu_torch.ops.rng import key_data
    from miniworld_tpu_torch.render import cuda_build

    state, obs = env.reset(seed=0)
    if warmup:
        state, obs, _ = env.rollout(state, obs, key_data(100, env.device), horizon)
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    times, outs = [], []
    for trial in range(trials):
        key = key_data(1000 + trial, env.device)
        t0 = time.perf_counter()
        state, obs, out = env.rollout(state, obs, key, horizon)
        torch.cuda.synchronize()
        out = {k: v.cpu().numpy() for k, v in out.items()}  # host fetch fence
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = dict(cuda_build.LAUNCHES)
    rate = env.num_envs * horizon * trials / sum(times)
    say("main-path", path=label, env=env.spec.gym_id, B=env.num_envs,
        obs=f"{env.obs_width}x{env.obs_height}", ss=env.supersample,
        horizon=horizon, trials=trials, env_steps_per_s=f"{rate:.1f}",
        trial_s=",".join(f"{t:.4f}" for t in times), launches=launches)
    return rate, outs, obs, launches, state


def check_rollout(env, outs, obs, launches, horizon, trials, kernels):
    """Checksums vary across trials, each of ``kernels`` launched at least
    once per step, outputs of the right shape, depth in (NEAR, FAR]."""
    from miniworld_tpu_torch.render import raycast as rc

    sums = [int(o["obs_sum"].sum()) for o in outs]
    if len(set(sums)) != len(sums):
        raise AssertionError(f"obs checksums do not vary across trials: {sums}")
    for k in kernels:
        if launches[k] < horizon * trials:
            raise AssertionError(f"kernel {k} launched {launches[k]} times in "
                                 f"{trials} rollouts of {horizon} steps")
    for o in outs:
        for k in ("reward", "dones", "obs_sum"):
            if o[k].shape != (horizon,):
                raise AssertionError(f"{k} shape {o[k].shape}")
    rgb, depth = obs
    if env.spec.dict_obs:  # {"obs": image, "goal": (B,) int32}
        goal = rgb["goal"]
        if goal.shape != (env.num_envs,) or goal.dtype != torch.int32 or \
                bool((goal != env.spec.goal).any()):
            raise AssertionError(f"goal {tuple(goal.shape)} {goal.dtype}")
        rgb = rgb["obs"]
    if rgb.shape != (env.num_envs, env.obs_height, env.obs_width, 3) or rgb.dtype != torch.uint8:
        raise AssertionError(f"rgb {tuple(rgb.shape)} {rgb.dtype}")
    d = depth.float()
    if not (bool(torch.isfinite(d).all()) and float(d.min()) > rc.NEAR
            and float(d.max()) <= rc.FAR):
        raise AssertionError("depth outside (NEAR, FAR]")
    say("main-path-check", env=env.spec.gym_id, checksums=sums,
        rewards=",".join(f"{o['reward'].sum():.4f}" for o in outs),
        dones=",".join(str(int(o["dones"].sum())) for o in outs))


def compare_paths(outs, plain_outs, label, obs_sum_rtol=1e-4):
    """Kernel and plain rollouts step the same envs through the same
    episodes: rewards and dones equal, checksums within ``obs_sum_rtol``."""
    for o_k, o_p in zip(outs, plain_outs):
        if not (np.array_equal(o_k["reward"], o_p["reward"])
                and np.array_equal(o_k["dones"], o_p["dones"])):
            raise AssertionError(f"{label}: kernel and plain paths disagree on rewards/dones")
    worst = max(float((np.abs(a["obs_sum"] - b["obs_sum"])
                       / np.maximum(b["obs_sum"], 1)).max())
                for a, b in zip(outs, plain_outs))
    if worst > obs_sum_rtol:
        raise AssertionError(f"{label}: obs checksums differ by {worst:.3e}")
    say("main-path-parity", env=label, paths="kernels vs plain", rewards_dones="equal",
        obs_sum_max_rel_diff=f"{worst:.3e}")


def host_ms(fn, iters: int, warmup: bool = True) -> float:
    """Mean host-clock time of fn() over ``iters`` runs, fenced by
    torch.cuda.synchronize() (includes launch overhead), after one call
    unless ``warmup`` is False."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_breakdown(env, render_iters=5, plain_render_iters=3):
    """Where a rollout step's time goes: the step with its auto-reset
    (maze generation and placement by the kernels, then by their plain
    versions), and the render with the kernels and with the plain
    versions (``plain_render_iters=0``: the plain render not timed, on the
    paths beyond the first four, which keeps the script's time in bounds:
    at B=8192 one plain render takes seconds)."""
    from miniworld_tpu_torch.ops.rng import key_data

    state, _ = env.reset(seed=0)
    acts = env.sample_actions(key_data(5, env.device))
    step_ms = host_ms(lambda: env._step_batch(state, acts), 5)
    render_ms = host_ms(lambda: env.render(state), render_iters)
    env.use_kernels = False
    try:
        step_plain_ms = host_ms(lambda: env._step_batch(state, acts), 3)
        # the plain render of one step takes seconds at the Maze's shapes:
        # timed over one call, without a warm-up call
        plain_ms = "not measured"
        if plain_render_iters:
            plain_ms = host_ms(lambda: env.render(state), plain_render_iters,
                               warmup=plain_render_iters > 1)
            plain_ms = f"{plain_ms:.3f}"
    finally:
        env.use_kernels = True
    say("breakdown", env=env.spec.gym_id, B=env.num_envs,
        step_and_reset_ms=f"{step_ms:.3f}", step_and_reset_plain_reset_ms=f"{step_plain_ms:.3f}",
        render_kernels_ms=f"{render_ms:.3f}", render_plain_ms=plain_ms)
    phase_profile(env, state)


def phase_profile(env, state, steps=PROFILE_STEPS, path="kernels"):
    """torch.profiler over a kernel-path rollout of the main path's
    horizon: device events and device-busy time per step (the rollout's
    action draw for the whole horizon included, as on the main path; the
    draw's own device events beside them), and the wall time under the
    profiler (the idle share is 1 - busy / wall). ``path`` labels the
    line (e.g. "mesh_rows=plain" under ``plain_mesh_rows``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from miniworld_tpu_torch.ops.rng import key_data

    obs = env.render(state)
    env.rollout(state, obs, key_data(9, env.device), 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        env.rollout(state, obs, key_data(10, env.device), steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / steps if events else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as draw:
        env.rollout_actions(key_data(10, env.device), steps)
        torch.cuda.synchronize()
    n_draw = sum(e.device_type == DeviceType.CUDA for e in draw.events())
    say("profile", env=env.spec.gym_id, B=env.num_envs, path=path, steps=steps,
        device_events_per_step=len(events) // steps if events else "not measured",
        action_draw_device_events=n_draw if events else "not measured",
        device_busy_ms_per_step=f"{busy_ms:.3f}" if busy_ms is not None else "not measured",
        wall_ms_per_step_under_profiler=f"{wall_ms:.3f}",
        idle_share=f"{1.0 - busy_ms / wall_ms:.3f}" if busy_ms is not None else "not measured")


def kernel_and_plain(env, horizon, trials, kernels, exact=False):
    """The env's rollouts with the kernels, then with every stage plain
    (no launch allowed), compared; ``exact``: checksums and the final
    mazes (procgen) equal too."""
    rate, outs, obs, launches, state = rollouts(env, "kernels", horizon, trials)
    check_rollout(env, outs, obs, launches, horizon, trials, kernels)
    env.use_kernels = False
    try:
        plain_rate, plain_outs, _, plain_launches, plain_state = rollouts(
            env, "plain", horizon, trials)
    finally:
        env.use_kernels = True
    if any(plain_launches.values()):
        raise AssertionError(f"plain path launched kernels: {plain_launches}")
    compare_paths(outs, plain_outs, env.spec.gym_id, 0.0 if exact else 1e-4)
    if exact and env.procgen:
        if not torch.equal(state.wall_open, plain_state.wall_open):
            raise AssertionError(f"{env.spec.gym_id}: final mazes differ between the paths")
        say("main-path-parity", env=env.spec.gym_id, final_wall_open="equal",
            final_step_count_max=int(state.step_count.max()))
    return rate, plain_rate, outs, state


def phase_rollout_keys(env, horizon=5):
    """A rollout is a function of its state and key: one key gives the
    same per-step sums twice, another key other sums."""
    from miniworld_tpu_torch.ops.rng import key_data

    state, obs = env.reset(seed=3)
    outs = [env.rollout(state, obs, key_data(k, env.device), horizon)[2] for k in (7, 7, 8)]
    outs = [{k: v.cpu().numpy() for k, v in o.items()} for o in outs]
    same = all(np.array_equal(outs[0][k], outs[1][k]) for k in outs[0])
    other = not np.array_equal(outs[0]["obs_sum"], outs[2]["obs_sum"])
    say("rollout-keys", env=env.spec.gym_id, B=env.num_envs, horizon=horizon,
        same_key_same_sums=same, other_key_other_sums=other)
    if not (same and other):
        raise AssertionError("rollouts do not follow their keys")


def phase_main(hall, pick, pick_small, four, tmaze):
    hall_kernels = ("tri_pass", "entity_pass", "pixel_epilogue", "place")
    pick_kernels = hall_kernels + ("entity_mesh_pass",)
    rates = {}
    # the line of record through the kernels, then against the plain path
    rate, outs, obs, launches, _ = rollouts(hall, "kernels", HORIZON, TRIALS)
    check_rollout(hall, outs, obs, launches, HORIZON, TRIALS, hall_kernels)
    rates["hallway"] = (rate, None)
    rates[f"hallway_h{PLAIN_HORIZON}"] = kernel_and_plain(hall, PLAIN_HORIZON, TRIALS,
                                                         hall_kernels)[:2]
    phase_rollout_keys(hall)
    phase_breakdown(hall)

    # the PickupObjects main path: B=4096, its five kernels every step
    rate, outs, obs, launches, _ = rollouts(pick, "kernels", HORIZON, PICK_TRIALS)
    check_rollout(pick, outs, obs, launches, HORIZON, PICK_TRIALS, pick_kernels)
    total_reward = sum(float(o["reward"].sum()) for o in outs)
    if not total_reward > 0.0:
        raise AssertionError("no pickup rewarded in the PickupObjects rollouts")
    rates["pickupobjects"] = (rate, None)
    pick_launches = launches
    rates["pickupobjects_b1024"] = kernel_and_plain(pick_small, PLAIN_HORIZON, TRIALS,
                                                    pick_kernels)[:2]
    for env in (four, tmaze):
        r, outs, obs, launches, _ = rollouts(env, "kernels", SHORT_HORIZON, TRIALS)
        check_rollout(env, outs, obs, launches, SHORT_HORIZON, TRIALS, hall_kernels)
        rates[env.spec.name.lower()] = (r, None)
    phase_breakdown(pick, render_iters=5)
    phase_profile_plain_rows(pick)
    return pick_launches, rates


def phase_maze(maze, maze_s3, maze_s3_bank, rates):
    """The Maze 8x8 procgen main path at B=8192 (a fresh maze per reset,
    every reset computed each step), its breakdown; the MazeS3 procgen
    rollout with 10-step episodes against its plain path, exactly; a
    short MazeS3 bank-mode rollout. Returns the main path's launches."""
    rate, outs, obs, launches, _ = rollouts(maze, "kernels", HORIZON, TRIALS)
    check_rollout(maze, outs, obs, launches, HORIZON, TRIALS, MAZE_KERNELS)
    rates["maze8x8_procgen_b8192"] = (rate, None)
    phase_breakdown(maze, render_iters=5, plain_render_iters=1)

    rate, plain_rate, outs, state = kernel_and_plain(
        maze_s3, MAZE_S3_HORIZON, TRIALS, MAZE_KERNELS, exact=True)
    # every env resets at least once a trial: each truncates at 10 steps
    resets = min(int(o["dones"].sum()) for o in outs)
    if resets < maze_s3.num_envs * (MAZE_S3_HORIZON // MAZE_S3_STEPS):
        raise AssertionError(f"MazeS3: {resets} resets in a {MAZE_S3_HORIZON}-step trial")
    if int(state.step_count.max()) > MAZE_S3_STEPS:
        raise AssertionError("MazeS3: an env ran past its episode length")
    rates["mazes3_procgen_b1024"] = (rate, plain_rate)

    r, outs, obs, bank_launches, _ = rollouts(maze_s3_bank, "kernels", SHORT_HORIZON, TRIALS)
    check_rollout(maze_s3_bank, outs, obs, bank_launches, SHORT_HORIZON, TRIALS,
                  ("tri_pass", "entity_pass", "pixel_epilogue", "place"))
    if bank_launches["mazegen"]:
        raise AssertionError("bank-mode MazeS3 generated mazes")
    rates["mazes3_bank_b1024"] = (r, None)
    return launches


def phase_wide(side, wall, nav, rates):
    """The multi-chunk main paths: Sidewalk, WallGap and NavigateWallGap at
    B=1024 through MiniWorldVec.rollout (every kernel each step, the
    tri_pass launch scanning 3 or 2 chunks); Sidewalk's breakdown.
    Returns Sidewalk's launches."""
    kernels = ("tri_pass", "entity_pass", "pixel_epilogue", "place")
    side_launches = None
    for env in (side, wall, nav):
        rate, outs, obs, launches, _ = rollouts(env, "kernels", HORIZON, TRIALS)
        check_rollout(env, outs, obs, launches, HORIZON, TRIALS, kernels)
        rates[env.spec.name.lower() + f"_b{env.num_envs}"] = (rate, None)
        if env is side:
            side_launches = launches
    phase_breakdown(side, render_iters=5, plain_render_iters=1)
    return side_launches


def phase_new_ids(make_env, rates):
    """Kernel and plain rollouts agree on rewards and dones (checksums
    within 1e-4) for Sidewalk, WallGap, NavigateWallGap and YMaze at
    B_PLAIN; short B=1024 rollouts of the OneRoom and YMaze families,
    each checked."""
    kernels = ("tri_pass", "entity_pass", "pixel_epilogue", "place")
    for env_id in (SIDE_ID, WALL_ID, NAV_ID, "MiniWorld-YMaze-v0"):
        env = make_env(env_id, B_PLAIN)
        rate, plain_rate, _, _ = kernel_and_plain(env, PLAIN_HORIZON, TRIALS, kernels)
        rates[env.spec.name.lower() + f"_b{B_PLAIN}"] = (rate, plain_rate)
    for env_id in SHORT_IDS:
        env = make_env(env_id, B)
        rate, outs, obs, launches, _ = rollouts(env, "kernels", SHORT_HORIZON, TRIALS)
        check_rollout(env, outs, obs, launches, SHORT_HORIZON, TRIALS, kernels)
        rates[env.spec.name.lower()] = (rate, None)


# ---------------------------------------------------------------------------
# the trainers: rollouts that a policy drives, the learner's update


def train_run(env, make, label, iters, warmup, smi):
    """``warmup`` then ``iters`` timed iterations of the train step that
    ``make(env)`` builds, from ``init(key_data(0))``; each iteration's
    metrics fetched to the host (the fence), its rollout timed apart
    (synced before and after). Checks: every metric finite, the
    parameters moved, each of the path's kernels launched ``horizon``
    times an iteration. Returns (env-steps/s, the timed iterations'
    launches, the last metrics, a summary for the JSON line)."""
    from miniworld_tpu_torch.ops.rng import key_data, split
    from miniworld_tpu_torch.render import cuda_build

    step, init = make(env)
    ts, state, obs, depth = init(key_data(0, env.device))
    before = {n: p.detach().clone() for n, p in ts["params"].named_parameters()}
    rollout_s, orig = [], env.rollout

    def timed_rollout(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        rollout_s.append(time.perf_counter() - t0)
        return out

    env.rollout = timed_rollout
    try:
        key = key_data(1, env.device)
        for _ in range(warmup):
            key, k = split(key, 2)
            ts, state, obs, depth, _ = step(ts, state, obs, depth, k)
        torch.cuda.synchronize()
        rollout_s.clear()
        cuda_build.reset_launch_counts()
        times = []
        for _ in range(iters):
            key, k = split(key, 2)
            t0 = time.perf_counter()
            ts, state, obs, depth, m = step(ts, state, obs, depth, k)
            m = {name: float(v) for name, v in m.items()}  # host fetch fence
            times.append(time.perf_counter() - t0)
        launches = dict(cuda_build.LAUNCHES)
    finally:
        del env.rollout  # the instance's wrapper: the method again
    horizon = TRAIN_HORIZON
    if not all(math.isfinite(v) for v in m.values()):
        raise AssertionError(f"{label}: metrics not finite: {m}")
    moved = max(float((before[n] - p.detach()).abs().max())
                for n, p in ts["params"].named_parameters())
    if not moved > 0.0:
        raise AssertionError(f"{label}: the parameters did not move")
    if ts["params"].continuous and not float(
            (before["log_std"] - ts["params"].log_std.detach()).abs().max()) > 0.0:
        raise AssertionError(f"{label}: log_std did not move")
    for kname in path_kernels(env):
        if launches[kname] != horizon * iters:
            raise AssertionError(f"{label}: {kname} launched {launches[kname]} times in "
                                 f"{iters} iterations of {horizon} steps")
    rate = env.num_envs * horizon * iters / sum(times)
    step_ms = [t * 1e3 for t in times]
    roll_ms = [t * 1e3 for t in rollout_s]
    upd_ms = [a - b for a, b in zip(step_ms, roll_ms)]
    say("train", path=label, env=env.spec.gym_id, B=env.num_envs,
        obs=f"{env.obs_width}x{env.obs_height}", horizon=horizon, warmup=warmup, iters=iters,
        env_steps_per_s=f"{rate:.1f}", step_ms=",".join(f"{t:.2f}" for t in step_ms),
        rollout_ms=",".join(f"{t:.2f}" for t in roll_ms),
        update_ms=",".join(f"{t:.2f}" for t in upd_ms),
        metrics=",".join(f"{k}:{v:.5g}" for k, v in m.items()), params_moved=f"{moved:.3e}",
        launches={k: launches[k] for k in path_kernels(env)}, card=repr(smi))
    summary = {"env": env.spec.gym_id, "B": env.num_envs, "horizon": horizon, "iters": iters,
               "env_steps_per_s": rate, "step_ms": step_ms, "rollout_ms": roll_ms,
               "update_ms": upd_ms, "card": smi}
    return rate, launches, m, summary


def train_learner_times(env, smi):
    """The learner's layers at the A2C path's batch (TRAIN_HORIZON x B
    frames of the env's observations, actions and returns): forward under
    no_grad, the A2C loss's forward + backward, one Adam update; CUDA
    events (cuda_ms). Then one A2C step under torch.profiler: device busy
    ms, events and the idle share (1 - busy / wall), the five device
    kernels that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from miniworld_tpu_torch.ops.rng import key_data
    from miniworld_tpu_torch.parallel import learner as L, make_train_step

    step, init = make_train_step(env, horizon=TRAIN_HORIZON)
    ts, state, obs, depth = init(key_data(0, env.device))
    net, n = ts["params"], TRAIN_HORIZON * env.num_envs
    rgb = obs.repeat(TRAIN_HORIZON, 1, 1, 1)
    dep = depth.repeat(TRAIN_HORIZON, 1, 1, 1)
    acts = torch.randint(0, env._action_table.shape[0], (n,), device=env.device)
    rets = torch.rand(n, device=env.device)

    def fwd():
        with torch.no_grad():
            L.forward(net, rgb, dep)

    def fwd_bwd():
        L.loss_grads(net, L.a2c_loss(net, rgb, dep, acts, rets))

    grads = L.loss_grads(net, L.a2c_loss(net, rgb, dep, acts, rets))
    opt = ts["opt"]

    def adam():
        L.adam_update(net, grads, opt)

    times = {k: cuda_ms(f, 5) for k, f in (("forward", fwd), ("forward_backward", fwd_bwd),
                                             ("adam", adam))}
    key = key_data(3, env.device)
    ts, state, obs, depth, _ = step(ts, state, obs, depth, key)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts, state, obs, depth, m = step(ts, state, obs, depth, key)
        float(m["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    say("train-learner", env=env.spec.gym_id, frames=n, obs=f"{env.obs_width}x{env.obs_height}",
        **{f"{k}_ms": f"{v:.3f}" for k, v in times.items()}, card=repr(smi))
    say("train-profile", path="a2c", B=env.num_envs, horizon=TRAIN_HORIZON,
        device_busy_ms=f"{busy_ms:.3f}" if events else "not measured",
        device_events=len(events) if events else "not measured", wall_ms=f"{wall_ms:.3f}",
        idle_share=f"{1.0 - busy_ms / wall_ms:.3f}" if events else "not measured",
        top_device_ms=repr([(name[:60], round(ms, 3)) for name, ms in top]))
    return {**times, "device_busy_ms": busy_ms if events else None, "wall_ms_profiled": wall_ms}


def train_rollout_parity(env):
    """At B_PLAIN, one iteration's rollout under the learner's policy
    (init parameters, one key) with the kernels and with every stage
    plain: actions, rewards, dones and the per-step checksums equal; the
    plain one launches nothing."""
    from miniworld_tpu_torch.ops.rng import key_data
    from miniworld_tpu_torch.parallel import make_train_step, train
    from miniworld_tpu_torch.render import cuda_build

    _, init = make_train_step(env, horizon=TRAIN_HORIZON)
    ts, state, obs, depth = init(key_data(0, env.device))
    policy = train._policy_factory(ts["params"], False)
    outs, launches = [], []
    for use in (True, False):
        env.use_kernels = use
        cuda_build.reset_launch_counts()
        try:
            _, _, o = env.rollout(state, (obs, depth), key_data(5, env.device), TRAIN_HORIZON,
                                  policy=policy, return_actions=True)
        finally:
            env.use_kernels = True
        outs.append({k: v.cpu() for k, v in o.items()})
        launches.append(dict(cuda_build.LAUNCHES))
    if any(launches[1].values()):
        raise AssertionError(f"plain policy rollout launched kernels: {launches[1]}")
    for k in ("actions", "rewards", "done_mask", "reward", "dones", "obs_sum"):
        if not torch.equal(outs[0][k], outs[1][k]):
            raise AssertionError(f"policy rollout: kernels and plain differ in {k}")
    say("train-parity", env=env.spec.gym_id, B=env.num_envs, horizon=TRAIN_HORIZON,
        paths="kernels vs plain", actions_rewards_dones_checksums="equal",
        actions_taken=int(outs[0]["actions"].unique().numel()),
        kernel_launches={k: v for k, v in launches[0].items() if v})


def phase_train(make_env, smi):
    """The trainers' main paths: A2C and PPO on OneRoomS6Fast at B_TRAIN,
    80x60, through ``make_train_step`` / ``make_ppo_step``, the learner's
    layers timed and one A2C step profiled; one A2C step
    of the Gaussian head (``set_discrete_actions(None)``) and one on
    Sign's dict observations at B_TRAIN_SIDE; the policy's rollout kernels
    vs plain at B_PLAIN. Returns (per-path launches, the JSON summary)."""
    from miniworld_tpu_torch.parallel import make_ppo_step, make_train_step

    def a2c(env):
        return make_train_step(env, horizon=TRAIN_HORIZON)

    def ppo(env):
        return make_ppo_step(env, horizon=TRAIN_HORIZON, epochs=TRAIN_EPOCHS,
                             minibatches=TRAIN_MINIBATCHES)

    env = make_env(TRAIN_ID, B_TRAIN)
    launches, summary = {}, {}
    for label, make in (("a2c", a2c), ("ppo", ppo)):
        _, launches[label], _, summary[f"{label}_b{B_TRAIN}"] = train_run(
            env, make, label, TRAIN_ITERS, TRAIN_WARMUP, smi)
    summary["learner"] = train_learner_times(env, smi)
    gauss = make_env(TRAIN_ID, B_TRAIN_SIDE)
    gauss.set_discrete_actions(None)
    _, _, _, summary[f"a2c_gaussian_b{B_TRAIN_SIDE}"] = train_run(
        gauss, a2c, "a2c gaussian head", 1, 0, smi)
    _, _, _, summary[f"a2c_sign_b{B_TRAIN_SIDE}"] = train_run(
        make_env(SIGN_ID, B_TRAIN_SIDE), a2c, "a2c sign (dict obs)", 1, 0, smi)
    train_rollout_parity(make_env(TRAIN_ID, B_PLAIN))
    return launches, summary


# ---------------------------------------------------------------------------
# the gymnasium adapter (gym_env.py: one env, host physics, renders on the
# card at a batch of one) and the layout-bank refresh


def gym_actions(env, n, seed):
    """``n`` seeded actions for a ``SingleEnv``: table indices, the
    camera's ids or clicks, or 6-D vectors in the action box."""
    rng = np.random.default_rng(seed)
    spec = env.spec_def
    if env._discrete_actions is not None:
        return [int(a) for a in rng.integers(0, len(env._discrete_actions), n)]
    if getattr(spec, "num_actions", 0):
        return [int(a) for a in rng.integers(0, spec.num_actions, n)]
    if getattr(spec, "click_action", False):
        return list(rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32))
    return list(rng.uniform([-1, -1, -1, -1, 0, 0], 1.0, (n, 6)).astype(np.float32))


def gym_same(label, k, p):
    """Raise unless the kernel frame ``k`` equals the plain one ``p``
    ((rgb, depth) numpy pairs) exactly; returns the largest difference."""
    err = max(float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())
              for a, b in zip(k, p))
    if not all(np.array_equal(a, b) for a, b in zip(k, p)):
        raise AssertionError(f"[gym] {label}: kernel frame differs from plain by {err}")
    return err


def gym_plain(env, fn):
    """``fn()`` with the env's plain renders (no launches)."""
    env.use_kernels = False
    try:
        return fn()
    finally:
        env.use_kernels = True


def phase_gym(smi):
    """The gymnasium adapter's main path on the card, every id: reset and
    GYM_STEPS steps at 80x60 with the kernels, each step's observation
    and an RGB-D render (render_depth) equal to the plain render of the
    same state exactly; on GYM_TOP_IDS the view="top" observation and
    get_visible_ents too. Launch counts from that run (the comparisons'
    plain renders launch nothing); the goldens (tests/golden,
    tests/golden_ref) replayed bit for bit; frames a second on
    GYM_FPS_IDS (reset and steps, the render included). Returns (the
    path's launches, the largest kernel-vs-plain difference, the JSON
    summary)."""
    import glob

    from miniworld_tpu_torch.envs import ENV_IDS
    from miniworld_tpu_torch.gym_env import SingleEnv
    from miniworld_tpu_torch.render import cuda_build

    names = [i.split("-")[1] for i in ENV_IDS]
    envs = {n: SingleEnv(n, obs_width=W, obs_height=H, device=DEVICE) for n in names}
    tops = {n: SingleEnv(n, obs_width=W, obs_height=H, device=DEVICE, view="top")
            for n in GYM_TOP_IDS}
    torch.cuda.synchronize()
    err, frames, seen = 0.0, 0, 0
    plans = {}
    cuda_build.reset_launch_counts()
    for n in names:
        env = envs[n]
        obs, _ = env.reset(seed=GYM_SEED)
        st = env.render_statics()
        plans[n] = "1" if st.plan is None else f"{st.plan['nc']}x{st.plan['tri_chunk']}"
        for t, a in enumerate([None] + gym_actions(env, GYM_STEPS, GYM_SEED)):
            if a is not None:
                obs = env.step(a)[0]  # an episode that ends goes on, as the reference's
            kern = env.render_depth()
            plain = gym_plain(env, env.render_depth)
            img = obs["obs"] if isinstance(obs, dict) else obs
            err = max(err, gym_same(f"{n} step {t}", kern, plain), gym_same(
                f"{n} step {t} obs", (img,), (kern[0],)))
            frames += 1
            if n in tops:
                vis_k = sorted(e.slot_idx for e in env.get_visible_ents())
                vis_p = sorted(e.slot_idx for e in gym_plain(env, env.get_visible_ents))
                if vis_k != vis_p:
                    raise AssertionError(f"[gym] {n} step {t}: visible {vis_k} vs {vis_p}")
                seen += len(vis_k)
        if n in tops:
            top = tops[n]
            t_obs, _ = top.reset(seed=GYM_SEED)
            for t, a in enumerate([None] + gym_actions(top, GYM_STEPS, GYM_SEED)):
                if a is not None:
                    t_obs = top.step(a)[0]
                kern = top.render_depth()
                err = max(err, gym_same(f"{n} top step {t}", kern,
                                        gym_plain(top, top.render_depth)),
                          gym_same(f"{n} top obs {t}", (t_obs,), (kern[0],)))
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    missing = [k for k in GYM_KERNELS if not launches.get(k)]
    say("gym", ids=len(names), frames=frames, top_ids=",".join(GYM_TOP_IDS),
        visible_entities=seen, max_abs_err=err, chunks=plans, launches=launches)
    if missing:
        raise AssertionError(f"[gym] kernels never launched on the adapter's path: {missing}")
    # the goldens: the float64 host physics, no render needed
    n_gold = 0
    for path in sorted(glob.glob(os.path.join(ROOT, "tests", "golden", "*.npz"))):
        name, seed = os.path.basename(path)[:-4].rsplit("_s", 1)
        g = np.load(path)
        env = SingleEnv(name, obs_width=W, obs_height=H, device=DEVICE, skip_obs=True)
        env.reset(seed=int(seed))
        ok = np.array_equal(env.agent_pos, g["spawn"])
        for t, a in enumerate(g["actions"]):
            _, r, term, trunc, _ = env.step(int(a) if np.ndim(a) == 0 else a)
            ok &= (np.array_equal(env.agent_pos, g["poses"][t]) and env.agent_dir == g["dirs"][t]
                   and r == g["rewards"][t] and bool(term) == bool(g["terms"][t]))
            if term or trunc:
                break
        if not ok:
            raise AssertionError(f"[gym] golden {path} does not replay")
        n_gold += 1
    for path in sorted(glob.glob(os.path.join(ROOT, "tests", "golden_ref", "*.npz"))):
        base = os.path.basename(path)[:-4]
        dr = base.endswith("_dr")
        name, seed = (base[:-3] if dr else base).rsplit("_s", 1)
        ref = np.load(path)
        env = SingleEnv(name, obs_width=W, obs_height=H, device=DEVICE, skip_obs=True,
                        domain_rand=dr)
        env.reset(seed=int(seed))
        ok = np.array_equal(env.agent_pos, ref["spawn_pos"]) and env.agent_dir == ref["spawn_dir"]
        steps = 0
        for t, a in enumerate(ref["actions"]):
            a = np.asarray(a)
            _, r, term, trunc, _ = env.step(int(a) if a.ndim == 0 else a)
            ok &= (np.array_equal(env.agent_pos, ref["pos"][t]) and env.agent_dir == ref["dir"][t]
                   and env.cam_pitch == ref["pitch"][t] and float(r) == ref["reward"][t]
                   and bool(term) == bool(ref["term"][t])
                   and bool(trunc) == bool(ref["trunc"][t]))
            steps += 1
            if term or trunc:
                break
        if not ok or steps != len(ref["pos"]):
            raise AssertionError(f"[gym] reference golden {path} does not replay")
        n_gold += 1
    say("gym-goldens", replayed=n_gold, bit_exact=True)
    # frames a second: reset, then steps (each one renders and fetches its
    # observation to the host), episodes reset as they end
    fps = {}
    for n in GYM_FPS_IDS:
        env = envs.get(n) or SingleEnv(n, obs_width=W, obs_height=H, device=DEVICE)
        acts = gym_actions(env, GYM_FPS_STEPS, 1)
        env.reset(seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env.reset(seed=2)
        for a in acts:
            _, _, term, trunc, _ = env.step(a)
            if term or trunc:
                env.reset()
        torch.cuda.synchronize()
        fps[n] = (GYM_FPS_STEPS + 1) / (time.perf_counter() - t0)
        say("gym-fps", env=n, obs=f"{W}x{H}", frames=GYM_FPS_STEPS + 1,
            frames_per_s=f"{fps[n]:.1f}", card=smi)
    return launches, err, {"frames_checked": frames, "goldens_replayed": n_gold,
                           "frames_per_s": fps, "obs": f"{W}x{H}", "chunks": plans}


def phase_refresh():
    """Layout-bank refresh at B_REFRESH: MazeS3 with 4 layouts (a full
    scan) and the 4x4 Maze with 4 (packed PVS), each refreshed, the plan
    unchanged, then reset and rolled out with the kernels and with the
    plain versions, exactly equal; then the A2C twin with
    --refresh-layouts-every 2. Returns the kernel rollouts' launches."""
    from miniworld_tpu_torch import MiniWorldVec, make_spec
    from miniworld_tpu_torch.examples import train_a2c
    from miniworld_tpu_torch.ops.rng import key_data
    from miniworld_tpu_torch.parallel import make_train_step
    from miniworld_tpu_torch.render import cuda_build

    launches = {}
    for label, env_id, kw, kind in (
            ("mazes3x4", MAZE_S3_ID, dict(num_layouts=4), "dense"),
            ("maze4x4x4", MAZE_ID, dict(num_rows=4, num_cols=4, num_layouts=4), "packed_pvs")):
        pair = [MiniWorldVec(make_spec(env_id, **kw), B_REFRESH, obs_width=W, obs_height=H,
                             device=DEVICE, procgen=False, use_kernels=uk) for uk in (True, False)]
        plan0 = {k: v for k, v in pair[0].plan.items() if k != "chunk_vis"}
        if plan0["kind"] != kind:
            raise AssertionError(f"[refresh] {label} plans {plan0}")
        prepared = pair[0].prepare_bank(REFRESH_SEED)
        outs = []
        for env in pair:
            env.install_bank(prepared)
            plan = {k: v for k, v in env.plan.items() if k != "chunk_vis"}
            if plan != plan0:
                raise AssertionError(f"[refresh] {label}: the plan changed, {plan0} -> {plan}")
            state, obs = env.reset(seed=3)
            torch.cuda.synchronize()
            cuda_build.reset_launch_counts()
            state, obs, out = env.rollout(state, obs, key_data(4, env.device), REFRESH_HORIZON)
            torch.cuda.synchronize()
            if env.use_kernels:
                launches[label] = dict(cuda_build.LAUNCHES)
            outs.append((state, obs, out))
        (sk, ok_, outk), (sp, op, outp) = outs
        same = all(torch.equal(outk[k], outp[k]) for k in outk)
        same &= torch.equal(ok_[0], op[0]) and torch.equal(ok_[1], op[1])
        same &= all(torch.equal(v, sp.tensors()[k]) for k, v in sk.tensors().items())
        if not same:
            raise AssertionError(f"[refresh] {label}: the kernel rollout differs from plain")
        for k in ("tri_pass", "pixel_epilogue", "entity_pass", "place"):
            if launches[label][k] < REFRESH_HORIZON:
                raise AssertionError(f"[refresh] {label}: {k} launched {launches[label][k]}")
        say("refresh", env=label, B=B_REFRESH, plan=plan0, horizon=REFRESH_HORIZON,
            kernels_equal_plain=True, launches=launches[label],
            dones=int(outk["dones"].sum()))
    # the A2C twin, refreshing the MazeS3 bank every 2 iterations
    installs, orig = [], MiniWorldVec.install_bank

    def counted(self, prepared):
        installs.append(1)
        return orig(self, prepared)

    args = train_a2c.parser("").parse_args(
        ["--env", MAZE_S3_ID, "--num-envs", str(B_REFRESH), "--obs", f"{W}x{H}", "--iters", "4",
         "--horizon", "8", "--refresh-layouts-every", "2", "--log-every", "2",
         "--device", DEVICE])
    MiniWorldVec.install_bank = counted
    try:
        t0 = time.perf_counter()
        train_a2c.run(args, lambda env: make_train_step(env, horizon=args.horizon),
                      env_kwargs={"procgen": False})
    finally:
        MiniWorldVec.install_bank = orig
    if len(installs) != 2:
        raise AssertionError(f"[refresh] the A2C twin installed {len(installs)} banks in 4 "
                             "iterations, refreshing every 2")
    say("refresh-train", env=MAZE_S3_ID, procgen=False, iters=4, refresh_every=2,
        banks_installed=len(installs), seconds=f"{time.perf_counter() - t0:.1f}")
    return launches


# ---------------------------------------------------------------------------
# the float32 carry above 256 ids and the dense super-bank kill


@contextlib.contextmanager
def transformed_banks(transform):
    """Within the block, the banks a MiniWorldVec constructor builds
    (``vector.build_bank``, ``vector.build_super_bank``) come out through
    ``transform(bank, tex) -> (bank, tex)``: ``widened`` (a Fourier atlas
    of more than 256 rows, ``vector.widen_atlas``), ``raised``
    (layout-local slot ids above 256, ``vector.raise_slot_ids``),
    ``dense`` (a super bank without its paired rows) or ``dense_widened``."""
    from miniworld_tpu_torch import vector

    orig = vector.build_bank, vector.build_super_bank
    vector.build_bank = lambda *a, **k: transform(*orig[0](*a, **k))
    vector.build_super_bank = lambda *a, **k: transform(*orig[1](*a, **k))
    try:
        yield
    finally:
        vector.build_bank, vector.build_super_bank = orig


def widened(bank, tex):
    from miniworld_tpu_torch import vector

    return vector.widen_atlas(bank, tex)


def raised(bank, tex):
    from miniworld_tpu_torch import vector

    return vector.raise_slot_ids(bank), tex


def dense(bank, tex):
    from miniworld_tpu_torch import vector

    return vector.drop_paired_rows(bank), tex


def dense_widened(bank, tex):
    return widened(*dense(bank, tex))


def f32_route(env, state):
    """(tri_args, mesh, paired, tri_chunk, override, carry, active) of the
    env's render of ``state`` at its samples, as render_rgbd passes them to
    tri_pass: its static rows (a schedule's chunk rows), mesh rows, paired
    rows, chunk (None for a schedule), texture-variant override, carry
    dtype and dense super-bank kill."""
    from miniworld_tpu_torch.render import raycast as rc

    ss = env.supersample
    cam = rc.camera_grid(state, env.obs_width * ss, env.obs_height * ss)
    nearest = env.tex_mode == "nearest"
    carry = rc.attr_carry_dtype(state.tex_map.shape[1] if nearest else env._atlas.shape[0])
    mesh = (rc.entity_mesh_rows(env._bank, state, not nearest)[:2] if env._shapes_present[2]
            else None)
    rows, paired = rc.static_rows(env._bank, state, cam, env._pg_wall, env.plan)
    override = None if env._slot_tex is None else (state.tri_slots, *env._slot_tex)
    active = None if env._row_code is None else (env._row_code, state.wall_open)
    tc = env.tri_chunk if rows[2].dim() == 1 else None
    return (*rows, cam, env._all_quads), mesh, paired, tc, override, carry, active


def check_f32_dense(label, env, state, want, whole=True):
    """The env's render of ``state`` stage by stage, kernels against plain
    versions on the same inputs, exactly: tri_pass in its carry (t and the
    16 attributes bit for bit; with the override also against the launch
    without it), entity_pass, the epilogue on the kernel's hits (RGB and
    depth), then with ``whole`` the whole render (env.render, kernels
    against plain). Every name of ``want`` must launch. Returns (route,
    the epilogue's positional arguments and tex_map, max abs error)."""
    from miniworld_tpu_torch.render import cuda_build
    from miniworld_tpu_torch.render import raycast as rc

    route = f32_route(env, state)
    tri, mesh, paired, tc, override, carry, active = route
    cam = tri[3]
    case = (f"{label} B={env.num_envs} samples={cam.width}x{cam.height} K={env.fourier_k} "
            f"S={tri[0].shape[2]} tri_chunk={tc} carry={str(carry)[6:]}")
    before = dict(cuda_build.LAUNCHES)
    if override is None:
        t_k, a_k, err = check_tri_pass(tri, case, mesh, paired, tc, None, carry, active)
    else:
        err, _ = check_override(tri, override, case, mesh, paired, tc, carry, active)
        t_k, a_k = rc.tri_pass(*tri, mesh, paired, tc, override, carry, active)
    e_k = (None,) * 3
    if env._shapes_present[0] or env._shapes_present[1]:
        ent = (state.ent_pos, state.ent_size, state.ent_dir, state.ent_height, state.ent_color,
               rc.entity_flags(env._bank, state), cam, *env._shapes_present[:2])
        e_k = rc.entity_pass(*ent)
        err = max(err, check_entity_pass(e_k, rc.entity_pass_plain(*ent), case))
    tex_map = state.tex_map if env.tex_mode == "nearest" else None
    epi = (t_k, a_k, *e_k, env._atlas, cam, state.light_pos, state.light_color,
           state.light_ambient, state.sky_color, env.fourier_k, env._has_gain)
    ss = env.supersample
    outs = {"stage": (rc.pixel_epilogue(*epi, table=env._fourier_table, ss=ss, tex_map=tex_map),
                      rc.pixel_epilogue_plain(*epi, ss=ss, tex_map=tex_map))}
    if whole:
        kernels = env.render(state)
        env.use_kernels = False
        try:
            outs["render"] = (kernels, env.render(state))
        finally:
            env.use_kernels = True
    launched = {k: v - before[k] for k, v in cuda_build.LAUNCHES.items() if v > before[k]}
    for what, ((rgb_k, d_k), (rgb_p, d_p)) in outs.items():
        n_rgb = int((rgb_k != rgb_p).any(-1).sum())
        n_depth = int((d_k.view(torch.int32) != d_p.view(torch.int32)).sum())
        err = max(err, max_abs_diff(rgb_k, rgb_p), max_abs_diff(d_k, d_p))
        say("kernel-vs-plain", kernel="pixel_epilogue" if what == "stage" else "render",
            instance=f"SS={ss} {'NEAREST' if tex_map is not None else 'fourier'} "
            f"{str(carry)[6:]}{' GAIN' if env._has_gain else ''}", case=case,
            rgb_differs_px=n_rgb, depth_differs_px=n_depth,
            px_hit=f"{float(torch.isfinite(t_k).float().mean()):.3f}", exact=True)
        if n_rgb or n_depth or rgb_k.shape != (env.num_envs, env.obs_height, env.obs_width, 3):
            raise AssertionError(f"{case} {what}: kernels differ from plain on {n_rgb} RGB and "
                                 f"{n_depth} depth pixels")
    say("f32-dense-launched", case=case, launched=launched)
    if not set(want) <= set(launched):
        raise AssertionError(f"{case}: launched {launched}, expected {sorted(want)}")
    return route, (epi, tex_map), err


def active_hit_pairs(tri, active, block=32):
    """The (live row, pixel) pairs of a dense super bank that pass the hit
    test: tri_cull_stats' hit pairs without each env's killed rows."""
    from miniworld_tpu_torch.render import raycast as rc

    verts9, attr, layout_id, cam, all_quads = tri
    n = 0
    for lo in range(0, layout_id.shape[0], block):
        sl = slice(lo, lo + block)
        c = cam_rows(cam, sl)
        hits = rc.row_hits_plain(rc.stage_rows(verts9, attr, layout_id[sl], c), c, all_quads)
        live = rc.row_live(active[0][layout_id[sl].long()], active[1][sl])
        n += int((hits.sum(2) * live).sum())
    return n


def synthetic_codes(S, n_walls, gen):
    """(1, S) i32 maze kill codes (raycast.wall_codes) of a synthetic bank:
    two fifths of the rows no wall kills (-1), a tenth never drawn (-2),
    the rest live where one of ``n_walls`` walls is open (2w) or closed
    (2w + 1)."""
    u = torch.rand(S, generator=gen)
    walled = 2 * torch.randint(0, n_walls, (S,), generator=gen) + torch.randint(
        0, 2, (S,), generator=gen)
    return torch.where(u < 0.4, -1, torch.where(u < 0.5, -2, walled)).to(torch.int32)[None]


def store_cases(dev, n_walls=12):
    """[store-case]: the staged winner store and the compacted ACTIVE
    staging on synthetic banks, each launch against its plain version on
    every pixel (check_tri_pass, check_override): ties inside and across
    chunks (tie_case's 1,024 rows in one chunk and in 4 chunks of 256),
    4,096 rows all in view scanned in several windows with the carry
    between them (overflow_case in chunks of 1,024), 1,000 mesh rows an
    env seeding 64 static rows with misses of both (wide_inputs), the
    SCHED tie banks (sched_ties: repeated chunks, the mesh seed at a static
    row's key), all in the float32 carry, with and without the override;
    then tie_case's and overflow_case's banks with a maze kill (random
    codes over ``n_walls`` walls, each env's walls drawn): ACTIVE in one
    chunk and over several, bf16 and F32, with and without the override,
    staged by the bank's live_row_bound. Returns (max abs t error, the
    cases checked)."""
    from miniworld_tpu_torch.render import raycast as rc

    gen = torch.Generator().manual_seed(2121)
    f32 = torch.float32

    def override(tri):
        key = torch.randint(0, 1 << 32, (tri[2].shape[0],), generator=gen).to(dev)
        return key, spread_tex(torch.zeros(*tri[1].shape[:2], 4, device=dev), gen), None

    def kill(tri):
        codes = synthetic_codes(tri[0].shape[2], n_walls, gen)
        walls = (torch.rand((tri[2].shape[0], n_walls), generator=gen) < 0.5).float()
        return codes.to(dev), walls.to(dev)

    ties, ovf = tie_case(dev), overflow_case(dev, n=64)
    wide = wide_inputs(dev, gen)
    wide_tri = (*wide[:4], False)
    (rep, _), (seeded, smesh) = sched_ties(dev)
    cases = [("ties S=1024 one chunk", ties, {}), ("ties 4 chunks of 256", ties, {"tri_chunk": 256}),
             ("4096 rows in view, windows of 1024", ovf, {"tri_chunk": 1024}),
             ("wide mesh-seeded, misses", wide_tri, {"mesh": wide_mesh_rows(wide[3], gen)}),
             ("sched ties", rep, {}), ("sched ties mesh seed", seeded, {"mesh": smesh})]
    errs, checked = [0.0], []
    for label, tri, kw in cases:
        _, _, err = check_tri_pass(tri, f"{label} f32", attr_dtype=f32, **kw)
        err2, _ = check_override(tri, override(tri), f"{label} f32", attr_dtype=f32, **kw)
        errs += [err, err2]
        checked.append(label)
    for label, tri, tcs in (("ties S=1024", ties, (None, 256)),
                            ("4096 rows in view", ovf, (1024,))):
        act = kill(tri)
        for tc in tcs:
            for dt in (torch.bfloat16, f32):
                case = (f"{label} kill n_live={rc.live_row_bound(act[0])} tri_chunk={tc} "
                        f"{str(dt)[6:]}")
                _, _, err = check_tri_pass(tri, case, tri_chunk=tc, attr_dtype=dt, active=act)
                err2, _ = check_override(tri, override(tri), case, tri_chunk=tc, attr_dtype=dt,
                                         active=act)
                errs += [err, err2]
                checked.append(case)
    say("store-case", cases=len(checked), exact=True, max_abs_err=max(errs),
        checked=repr(checked))
    return max(errs), checked


def time_f32(name, route, epi_in, env, epi_name=None):
    """[kernel-time] of the route's tri_pass launch (``name``) and, with
    ``epi_name``, of its epilogue: CUDA events over 50 launches, the kernel
    alone under torch.profiler (``device_ms``), the plain version over one
    call, the bound (tri_work, epi_work or nearest_epi_work, with 64-byte
    rows in the float32 carry), and the same launches in the bf16 carry on
    the same inputs beside them (ids above 256 rounded: a time, not a
    render). Returns {name: (ms, plain_ms, device_ms, bound_ms, bound_by,
    bf16_ms, shapes)}."""
    from miniworld_tpu_torch.render import raycast as rc

    tri, mesh, paired, tc, override, carry, active = route
    epi, tex_map = epi_in
    ss = env.supersample
    f32 = carry == torch.float32
    shapes = (f"{env.spec.gym_id} B={env.num_envs} samples={tri[3].width}x{tri[3].height} "
              f"S={tri[0].shape[2]} K={env.fourier_k} carry={str(carry)[6:]}")

    def run(dt=carry):
        return rc.tri_pass(*tri, mesh, paired, tc, override, dt, active)

    hits = (active_hit_pairs(tri, active) if active is not None
            else tri_cull_stats(tri, paired, block=64)["hit_pairs"])
    mesh_w = None if mesh is None else (
        mesh[0], tri_cull_stats(tri, None, block=64, mesh_rows9=mesh[0])["hit_pairs"])
    out = {name: (cuda_ms(run, 50),
                  cuda_ms(lambda: plain_tri_pass(tri, mesh, paired, tc, override, carry, active),
                          1, PLAIN_WARMUP),
                  kernel_ms(run, 20, "tri_pass"),
                  *bound(*tri_work(tri, hits, paired, override, 64 if f32 else 32, mesh_w)),
                  cuda_ms(lambda: run(torch.bfloat16), 50) if f32 else None, shapes)}
    if epi_name is not None:
        kw = dict(table=env._fourier_table, ss=ss, tex_map=tex_map)
        ework = (epi_work(epi, env._fourier_table, env.fourier_k, ss, attr_bytes=64)
                 if tex_map is None else nearest_epi_work(epi, tex_map))
        t16, a16 = run(torch.bfloat16)
        out[epi_name] = (
            cuda_ms(lambda: rc.pixel_epilogue(*epi, **kw), 50),
            cuda_ms(lambda: rc.pixel_epilogue_plain(*epi, ss=ss, tex_map=tex_map), 1,
                    PLAIN_WARMUP),
            kernel_ms(lambda: rc.pixel_epilogue(*epi, **kw), 20, "pixel_epilogue"),
            *bound(*ework), cuda_ms(lambda: rc.pixel_epilogue(t16, a16, *epi[2:], **kw), 50),
            shapes)
    for k, (ms, plain, dev, b_ms, b_by, ms16, _) in out.items():
        say("kernel-time", kernel=k, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
            device_ms=fmt_ms(dev), bound_ms=f"{b_ms:.4f}", bound_by=b_by,
            bf16_same_inputs_ms=fmt_ms(ms16), shapes=shapes)
    return out


def phase_f32_dense(maze, maze_bank_w, make_env, rates):
    """[f32-dense]: the float32 carry above 256 ids (a Fourier atlas of more
    than 256 rows, ``widened``; nearest mode with its slot ids above 256,
    ``raised``) and the dense super-bank kill (the 8x8 procgen Maze without
    its paired rows, ``dense``). First the synthetic banks of store_cases;
    then each case's render against its plain
    versions, exactly (check_f32_dense), the new instances timed at their
    paths' shapes (time_f32): the Maze 8x8 procgen paths at B_MAZE, 80x60
    (domain_rand widened: paired F32 x OVERRIDE and the Fourier F32
    epilogue; dense and dense domain_rand: ACTIVE, beside the paired
    launch on the same states), then Sidewalk domain_rand widened (MULTI
    F32 x OVERRIDE), the 8x8 Maze bank ``maze_bank_w`` at 160x120
    supersample=2 domain_rand widened (SCHED x OVERRIDE x F32, the SS=2
    F32 epilogue at K=16), Sign widened (GAIN and MESH F32 at K=64),
    PickupObjects and ThreeRooms tri_chunk=16 nearest raised (MESH F32,
    SCHED x MESH F32) at B, and the dense Maze at 160x120 supersample=2
    B (ACTIVE over 2 chunks of 496), with the [store] lines (say_store); at
    B_PLAIN the remaining instances (the Maze nearest: paired F32; MESH
    and SCHED x MESH with OVERRIDE F32, ACTIVE F32, Sign SS=2 F32,
    K=6 with and without F32, SS=1 and SS=2, and its top view). Then the
    Maze paths' rollouts at B_MAZE and the others' at their B (launches a
    step), and the three Maze paths at B_PLAIN kernels against plain,
    exactly. Returns (max abs error, {name: timing}, {path: launches},
    checked cases)."""
    with shared_banks():  # one build a bank and texture mode
        return _f32_dense(maze, maze_bank_w, make_env, rates)


def _f32_dense(maze, maze_bank_w, make_env, rates):
    """phase_f32_dense's body."""
    from miniworld_tpu_torch.render import raycast as rc

    gen = torch.Generator().manual_seed(2121)
    f32 = {"tri_pass_f32", "pixel_epilogue_f32"}
    ov = {"tri_pass_override"}
    act = {"tri_pass_active"}
    with transformed_banks(widened):
        maze_w = make_env(MAZE_ID, B_MAZE, domain_rand=True)
        side_w = make_env(SIDE_ID, B, domain_rand=True)
        sign_w = make_env(SIGN_ID, B)
        small_w = [("maze8x8-procgen widened dr", make_env(MAZE_ID, B_PLAIN, domain_rand=True),
                    f32 | ov),
                   ("pickupobjects widened dr", make_env(PICK_ID, B_PLAIN, domain_rand=True),
                    f32 | ov | {"entity_mesh_pass"}),
                   ("threerooms tri_chunk=16 widened dr",
                    make_env(THREE_ID, B_PLAIN, domain_rand=True, tri_chunk=16),
                    f32 | ov | {"tri_pass_sched", "entity_mesh_pass"}),
                   ("sign widened ss=2", make_env(SIGN_ID, B_PLAIN, supersample=2),
                    f32 | {"pixel_epilogue_gain", "pixel_epilogue_ss2"}),
                   ("hallway K=6 widened", make_env(ENV_ID, B_PLAIN, fourier_k=6), f32),
                   ("maze8x8-procgen nearest", make_env(MAZE_ID, B_PLAIN, tex_mode="nearest"),
                    f32 | {"pixel_epilogue_nearest"}),
                   ("hallway K=6 widened ss=2", make_env(ENV_ID, B_PLAIN, fourier_k=6,
                                                         supersample=2),
                    f32 | {"pixel_epilogue_ss2"})]
    with transformed_banks(dense):
        maze_d = make_env(MAZE_ID, B_MAZE)
        maze_d_dr = make_env(MAZE_ID, B_MAZE, domain_rand=True)
        ss_d = [("maze8x8-procgen dense ss=2", make_env(MAZE_ID, B, supersample=2),
                 act | {"tri_pass_multi"}),
                ("maze8x8-procgen dense dr ss=2", make_env(MAZE_ID, B, supersample=2,
                                                          domain_rand=True),
                 act | ov | {"tri_pass_multi"}),
                ("maze8x8-procgen dense nearest ss=2", make_env(MAZE_ID, B, supersample=2,
                                                               tex_mode="nearest"),
                 act | f32 | {"tri_pass_multi"})]
        small_d = [("maze8x8-procgen dense", make_env(MAZE_ID, B_PLAIN), act),
                   ("maze8x8-procgen dense dr", make_env(MAZE_ID, B_PLAIN, domain_rand=True),
                    act | ov),
                   ("maze8x8-procgen dense nearest", make_env(MAZE_ID, B_PLAIN,
                                                              tex_mode="nearest"), act | f32)]
    with transformed_banks(dense_widened):
        ss_d.append(("maze8x8-procgen dense widened dr ss=2",
                     make_env(MAZE_ID, B, supersample=2, domain_rand=True),
                     act | ov | f32 | {"tri_pass_multi"}))
        small_d.append(("maze8x8-procgen dense widened dr",
                        make_env(MAZE_ID, B_PLAIN, domain_rand=True), act | ov | f32))
    with transformed_banks(raised):
        pick_r = make_env(PICK_ID, B, tex_mode="nearest")
        three_r = make_env(THREE_ID, B, tex_mode="nearest", tri_chunk=16)
    small_w.append(("hallway K=6", make_env(ENV_ID, B_PLAIN, fourier_k=6), set()))
    top_k6 = make_env(ENV_ID, B_PLAIN, fourier_k=6, view="top")
    plans = {"maze_w": (maze_w._pg_wall is not None, len(maze_w.plan["chunk_starts"]),
                        maze_w._atlas.shape[0] > 256),
             "maze_d": (maze_d._row_code is not None, maze_d._pg_wall, maze_d.plan["nc"],
                        maze_d.tri_chunk),
             "side_w": (side_w.plan["nc"], side_w.tri_chunk),
             "maze_bank_w": (maze_bank_w.plan["kind"], maze_bank_w.tri_chunk,
                             maze_bank_w.plan["sched_len"], maze_bank_w._atlas.shape[0] > 256),
             "three_r": (three_r.plan["kind"], three_r.plan["sched_len"],
                         three_r._bank.tex_slot_base.shape[1] > 256),
             "ss_d": [(e.plan["nc"], e.tri_chunk) for _, e, _ in ss_d]}
    say("f32-dense-plans", **{k: repr(v) for k, v in plans.items()})
    if plans["maze_w"] != (True, 1, True) or plans["maze_d"] != (True, None, 1, 832) \
            or plans["side_w"] != (3, 1024) or plans["maze_bank_w"] != ("packed_pvs", 96, 2, True) \
            or plans["three_r"][::2] != ("packed_pvs", True) \
            or any(p != (2, 496) for p in plans["ss_d"]):
        raise AssertionError(f"f32-dense plans {plans}")
    lap("f32-dense envs")

    store_err, checked = store_cases(DEVICE)
    errs, timings = [store_err], {}
    lap("f32-dense store cases")
    timed = [("maze8x8-procgen widened dr", maze_w, f32 | ov, "tri_pass_f32_override",
              "pixel_epilogue_fourier_f32"),
             ("maze8x8-procgen dense", maze_d, act, "tri_pass_active", None),
             ("maze8x8-procgen dense dr", maze_d_dr, act | ov, "tri_pass_active_override", None),
             ("sidewalk widened dr", side_w, f32 | ov | {"tri_pass_multi"},
              "tri_pass_multi_f32_override", None),
             ("maze8x8-bank widened dr ss=2", maze_bank_w,
              f32 | ov | {"tri_pass_sched", "pixel_epilogue_ss2"}, "tri_pass_sched_f32_override",
              "pixel_epilogue_ss2_f32"),
             ("sign widened", sign_w, f32 | {"pixel_epilogue_gain", "entity_mesh_pass"},
              "tri_pass_mesh_f32_sign", "pixel_epilogue_gain_f32"),
             ("pickupobjects nearest raised", pick_r,
              f32 | {"entity_mesh_pass", "pixel_epilogue_nearest"}, "tri_pass_mesh_f32", None),
             ("threerooms tri_chunk=16 nearest raised", three_r,
              f32 | {"entity_mesh_pass", "tri_pass_sched"}, "tri_pass_sched_mesh_f32", None),
             (*ss_d[0], "tri_pass_active_multi", None)]
    for label, env, want, name, epi_name in timed:
        state = view_states(env, gen)
        route, epi, err = check_f32_dense(label, env, state, want, whole=env.num_envs < B)
        errs.append(err)
        checked.append(label)
        timings.update(time_f32(name, route, epi, env, epi_name))
        if name == "tri_pass_active":  # the paired launch on the same states
            cam = route[0][3]
            rows, paired = rc.static_rows(maze._bank, state, cam, maze._pg_wall, maze.plan)
            timings["tri_pass_paired_same_states"] = (
                cuda_ms(lambda: rc.tri_pass(*rows, cam, maze._all_quads, None, paired,
                                            maze.tri_chunk), 50),)
            say("kernel-time", kernel="tri_pass (paired, the same states)",
                ms=f"{timings['tri_pass_paired_same_states'][0]:.4f}",
                shapes=f"{MAZE_ID} procgen B={B_MAZE} HW={W * H} Sp=608")
    say_store(timings)
    for label, env, want in ss_d[1:] + small_w + small_d:
        _, _, err = check_f32_dense(label, env, view_states(env, gen), want,
                                    whole=env.num_envs < B)
        errs.append(err)
        checked.append(label)
    # the K=6 table's top view (the padded rows in topview_epilogue)
    state = view_states(top_k6, gen)
    rgb_k, d_k = top_k6.render(state)
    top_k6.use_kernels = False
    try:
        rgb_p, d_p = top_k6.render(state)
    finally:
        top_k6.use_kernels = True
    n_top = int((rgb_k != rgb_p).any(-1).sum()) + int((d_k != d_p).sum())
    say("kernel-vs-plain", kernel="render", instance="view=top K=6", case=f"{ENV_ID} B={B_PLAIN}",
        differs_px=n_top, exact=True)
    if n_top:
        raise AssertionError(f"the K=6 top view: kernels differ from plain on {n_top} pixels")
    checked.append("hallway K=6 top view")
    lap("f32-dense stages")

    # the paths: the Maze ones at B_MAZE, the others at B; launches a step
    launches = {}
    for key, env, horizon in (("maze_w", maze_w, SHORT_HORIZON), ("maze_d", maze_d, SHORT_HORIZON),
                              ("maze_d_dr", maze_d_dr, SHORT_HORIZON),
                              ("side_w", side_w, SHORT_HORIZON),
                              ("maze_bank_w", maze_bank_w, SHORT_HORIZON),
                              ("sign_w", sign_w, SHORT_HORIZON), ("pick_r", pick_r, SHORT_HORIZON),
                              ("three_r", three_r, SHORT_HORIZON),
                              ("maze_d_ss2", ss_d[0][1], SHORT_HORIZON)):
        rate, outs, obs, lc, _ = rollouts(env, f"f32-dense {key}", horizon, TRIALS)
        check_rollout(env, outs, obs, lc, horizon, TRIALS, path_kernels(env))
        launches[key] = {k: v / (horizon * TRIALS) for k, v in lc.items() if v}
        launches[key]["steps"] = horizon * TRIALS
        rates[f"f32_dense_{key}_b{env.num_envs}"] = (rate, None)
    # kernels against plain on the Maze paths' small twins, exactly
    for label, env, _ in small_w[:1] + small_d[:2]:
        rates[f"f32_dense_{label.replace(' ', '_')}_b{B_PLAIN}"] = kernel_and_plain(
            env, PLAIN_HORIZON, TRIALS, path_kernels(env), exact=True)[:2]
    lap("f32-dense paths")
    say("f32-dense", cases_checked=len(checked), exact=True, max_abs_err=max(errs),
        paths=",".join(launches), instances_timed=",".join(k for k in timings))
    return max(errs), timings, launches, checked


def say_store(timings):
    """[store]: each timed tri_pass launch of [f32-dense] beside the same
    launch in the bf16 carry on the same inputs (ACTIVE: beside the paired
    launch on the same states) and its bound, with the card."""
    smi = card()
    paired = timings.get("tri_pass_paired_same_states", (None,))[0]
    for name, row in timings.items():
        if not name.startswith("tri_pass") or len(row) != 7:
            continue
        ms, _, dev, b_ms, b_by, ms16, shapes = row
        twin = {"bf16_same_inputs_ms": fmt_ms(ms16)} if ms16 is not None else {}
        if name == "tri_pass_active":
            twin["paired_same_states_ms"] = fmt_ms(paired)
        say("store", kernel=name, ms=f"{ms:.4f}", device_ms=fmt_ms(dev), **twin,
            bound_ms=f"{b_ms:.4f}", bound_by=b_by, of_bound=f"{b_ms / ms:.3f}", shapes=shapes,
            card=repr(smi))


# the [f32-dense] rows of the kernels line: (name, timing key, path of
# its launches and the counter, the TPU stage, instance of)
F32_ROWS = (
    ("tri_pass_f32_override", "maze_w", "tri_pass_f32", "miniworld_tpu/render/raycast.py:697",
     "tri_pass"),
    ("pixel_epilogue_fourier_f32", "maze_w", "pixel_epilogue_f32",
     "miniworld_tpu/render/raycast.py:1405", "pixel_epilogue"),
    ("tri_pass_active", "maze_d", "tri_pass_active", "miniworld_tpu/render/raycast.py:1220",
     "tri_pass"),
    ("tri_pass_active_override", "maze_d_dr", "tri_pass_active",
     "miniworld_tpu/render/raycast.py:1220", "tri_pass"),
    ("tri_pass_active_multi", "maze_d_ss2", "tri_pass_active",
     "miniworld_tpu/render/raycast.py:483", "tri_pass"),
    ("tri_pass_multi_f32_override", "side_w", "tri_pass_f32",
     "miniworld_tpu/render/raycast.py:444", "tri_pass"),
    ("tri_pass_sched_f32_override", "maze_bank_w", "tri_pass_f32",
     "miniworld_tpu/render/raycast.py:1166", "tri_pass"),
    ("pixel_epilogue_ss2_f32", "maze_bank_w", "pixel_epilogue_f32",
     "miniworld_tpu/render/raycast.py:1294", "pixel_epilogue"),
    ("tri_pass_mesh_f32_sign", "sign_w", "tri_pass_f32", "miniworld_tpu/render/raycast.py:838",
     "tri_pass"),
    ("pixel_epilogue_gain_f32", "sign_w", "pixel_epilogue_f32",
     "miniworld_tpu/render/raycast.py:656", "pixel_epilogue"),
    ("tri_pass_mesh_f32", "pick_r", "tri_pass_f32", "miniworld_tpu/render/raycast.py:838",
     "tri_pass"),
    ("tri_pass_sched_mesh_f32", "three_r", "tri_pass_f32", "miniworld_tpu/render/raycast.py:459",
     "tri_pass"),
)


def f32_kernel_rows(err, timings, launches, checked):
    """The kernels line's rows of the [f32-dense] instances: each timed at
    its path's shapes, with its launches in that path's rollouts and a
    step, and the bf16 launch on the same inputs beside it."""
    rows = []
    for name, path, counter, replaces, inst in F32_ROWS:
        ms, plain, dev, b_ms, b_by, ms16, shapes = timings[name]
        lc = launches[path]
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS[inst][0], "replaces": replaces,
            "launches": int(round(lc.get(counter, 0) * lc["steps"])), "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "instance_of": inst, "device_ms": dev, "bf16_same_inputs_ms": ms16,
            "launches_per_step": lc.get(counter, 0), "shapes": shapes, "checked_on": checked})
    rows[2]["paired_same_states_ms"] = timings["tri_pass_paired_same_states"][0]
    return rows


def phase_cli(smi):
    """[cli]: ``python -m miniworld_tpu_torch.manual_control`` headless,
    25 steps at 48x36 on the card (its default device), in a process of
    its own."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "miniworld_tpu_torch.manual_control",
         "MiniWorld-OneRoomS6Fast-v0", "--headless", "--steps", "25", "--obs-width", "48",
         "--obs-height", "36"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    secs = time.perf_counter() - t0
    say("cli", rc=proc.returncode, seconds=f"{secs:.1f}", stdout=repr(proc.stdout.strip()[-200:]),
        stderr=repr(proc.stderr.strip()[-400:]), card=repr(smi))
    if proc.returncode or "ran 25 steps on cuda" not in proc.stdout:
        raise AssertionError("the manual-control CLI's headless run failed on the card")


def main():
    smi = phase_device()
    sys.path.insert(0, ROOT)
    phase_build()
    sweep_builds = start_tile_sweep_builds()
    lap("build")
    from miniworld_tpu_torch import MiniWorldVec, make_spec

    def env(env_id, n, **kw):
        return MiniWorldVec(env_id, n, obs_width=W, obs_height=H, device=DEVICE, **kw)

    hall, pick = env(ENV_ID, B), env(PICK_ID, B_PICK)
    pick_small = env(PICK_ID, B)
    four, tmaze = env("MiniWorld-FourRooms-v0", B), env("MiniWorld-TMaze-v0", B)
    maze = env(MAZE_ID, B_MAZE)
    maze_s3 = MiniWorldVec(make_spec(MAZE_S3_ID, max_episode_steps=MAZE_S3_STEPS), B,
                           obs_width=W, obs_height=H, device=DEVICE)
    maze_s3_bank = MiniWorldVec(MAZE_S3_ID, B, obs_width=W, obs_height=H, device=DEVICE,
                                procgen=False)
    if not (maze.procgen and maze_s3.procgen):
        raise AssertionError("the Maze family does not default to procgen")
    side, wall, nav = env(SIDE_ID, B), env(WALL_ID, B), env(NAV_ID, B)
    room = env(ROOM_ID, B_ROOM)
    for e, n_chunks in ((side, 3), (wall, 2), (nav, 2)):
        if (e.plan["kind"], e._bank.tri_verts9.shape[2] // e.tri_chunk) != ("dense", n_chunks):
            raise AssertionError(f"{e.spec.gym_id} plans {e.plan}")
    lap("envs")
    errs, pick_timings, pick_work, sweep = phase_kernels(hall, pick)
    maze_errs, timings, work, maze_sweep = phase_maze_kernels(maze)
    lap("kernels")
    side_errs, side_timings, side_work = phase_chunks(side, env(SIDE_ID, B_STAGE),
                                                      env(WALL_ID, B_STAGE), sweep[0][1])
    lap("chunks")
    phase_tile_sweep(maze_sweep + sweep, sweep_builds)
    lap("tile-sweep")
    errs = {k: max(v, maze_errs.get(k, 0.0), side_errs.get(k, 0.0)) for k, v in errs.items()}
    errs["mazegen"], work["mazegen"], mazegen_chain_ms = phase_mazegen(maze, timings)
    errs["place"] = phase_place(pick, four, maze, room, timings, pick_timings, work, pick_work)
    lap("mazegen, place")
    for shapes, tms, wk in ((f"{PICK_ID} B={B_PICK} HW={W * H}", pick_timings, pick_work),
                            (f"{MAZE_ID} procgen B={B_MAZE} HW={W * H}", timings, work)):
        # at PickupObjects tri_pass is the launch with mesh rows, "_unmeshed"
        # the same without them
        for k, (ms, plain, *dev) in tms.items():
            extra = ({"bound_all_tries_ms": f"{bound(*wk['place_all_tries'])[0]:.4f}"}
                     if k == "place" else
                     {"bound_full_scan_ms": f"{bound(*wk['entity_pass_full_scan'])[0]:.4f}"}
                     if k == "entity_pass" else
                     {"chain_ms": fmt_ms(mazegen_chain_ms)} if k == "mazegen" else {})
            extra.update({"device_ms": fmt_ms(dev[0])} if dev else {})
            say("kernel-time", kernel=k, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
                bound_ms=f"{bound(*wk[k])[0]:.4f}", **extra, shapes=shapes)
    # domain randomisation and supersample=2: the override on every route,
    # the SS=2 epilogue, then their main paths
    maze_dr, four_dr = env(MAZE_ID, B_MAZE, domain_rand=True), env("MiniWorld-FourRooms-v0", B,
                                                                   domain_rand=True)
    hall_ss, pick_ss = env(ENV_ID, B, supersample=2), env(PICK_ID, B_PICK, supersample=2)
    routes = [("fourrooms", four_dr, True), ("hallway", env(ENV_ID, B, domain_rand=True), False),
              ("sidewalk", env(SIDE_ID, B_STAGE, domain_rand=True), False),
              ("maze8x8-procgen", maze_dr, True),
              ("maze8x8-bank", MiniWorldVec(make_spec(MAZE_ID, num_layouts=4), B, obs_width=W,
                                            obs_height=H, device=DEVICE, procgen=False,
                                            domain_rand=True), False),
              ("pickupobjects", env(PICK_ID, B, domain_rand=True), False)]
    plans = [(e.plan["kind"], e._bank.tri_verts9.shape[2] // e.tri_chunk, e._pg_wall is not None,
              e._shapes_present[2]) for _, e, _ in routes]
    if plans[2][:2] != ("dense", 3) or plans[3][2] is not True or plans[4][0] != "packed_pvs" \
            or plans[5][3] is not True:
        raise AssertionError(f"the override's routes plan {plans}")
    lap("dr, ss envs")
    sign, maze_ss = env(SIGN_ID, B), env(MAZE_ID, B_MAZE, supersample=2)
    gain_timings, gain_work, glyphs, gain_err = phase_gain_epilogue(sign)
    pc_err, pc_timings, pc_work, mss = phase_paired_chunks(maze_ss)
    errs["entity_pass"] = max(errs["entity_pass"], mss["entity_pass"][3])
    lap("gain-epilogue, paired-chunks")
    dr_err, dr_timings, dr_work = phase_dr_stages(routes)
    ss_timings, ss_work, ss_err, ss_floors = phase_ss_epilogue([("hallway", hall_ss),
                                                    ("pickupobjects", pick_ss)])
    lap("dr-stages, ss-epilogue")
    pick_launches, rates = phase_main(hall, pick, pick_small, four, tmaze)
    lap("main: hallway, pickupobjects, fourrooms, tmaze")
    maze_launches = phase_maze(maze, maze_s3, maze_s3_bank, rates)
    lap("main: maze")
    side_launches = phase_wide(side, wall, nav, rates)
    lap("main: sidewalk, wallgap, navigatewallgap")
    phase_new_ids(env, rates)
    lap("new ids")
    new_launches = phase_dr_ss_paths(maze_dr, four_dr, hall_ss, pick_ss, env, rates)
    lap("main: domain_rand, supersample=2")
    glyph_launches = phase_glyph_paths(sign, maze_ss, env, rates)
    lap("main: sign, maze ss=2, greenkey, threerooms")
    # nearest-mode textures: every new instance against its plain version
    # at B_PLAIN, then at the Maze 8x8 procgen nearest main path's shapes;
    # its main path, then the continuous-action ids'
    maze_n, hall_n = env(MAZE_ID, B_MAZE, tex_mode="nearest"), env(ENV_ID, B, tex_mode="nearest")
    near_cases = [
        ("hallway", env(ENV_ID, B_PLAIN, tex_mode="nearest"), None),
        ("pickupobjects", env(PICK_ID, B_PLAIN, tex_mode="nearest"), None),
        ("sidewalk", env(SIDE_ID, B_PLAIN, tex_mode="nearest"), None),
        ("sign", env(SIGN_ID, B_PLAIN, tex_mode="nearest"), None),
        ("maze8x8-procgen", env(MAZE_ID, B_PLAIN, tex_mode="nearest"), None),
        ("maze8x8-procgen ss=2", env(MAZE_ID, B_PLAIN, tex_mode="nearest", supersample=2), 496),
        ("fourrooms domain_rand", env("MiniWorld-FourRooms-v0", B_PLAIN, tex_mode="nearest",
                                      domain_rand=True), None),
        ("hallway (nearest path)", hall_n, None)]
    if near_cases[2][1].plan["chunk_starts"] != [0, 1024, 2048]:
        raise AssertionError(f"Sidewalk nearest plans {near_cases[2][1].plan}")
    near_err, near_timings, near_work, near_checked = phase_nearest_stages(near_cases, maze_n)
    lap("nearest-stages")
    # every epilogue instance reads entity_pass's colour and normal only
    # where its t is finite: NaN there changes no pixel
    ent_gen = torch.Generator().manual_seed(1414)
    pick_state = facing_states(pick, ent_gen, (0.5, 0.5), (11.5, 11.5))
    pick_ss_state = facing_states(pick_ss, ent_gen, (0.5, 0.5), (11.5, 11.5))
    pick_n = near_cases[1][1]
    phase_ent_undefined([
        ("pickupobjects", pick, pick_state, False), ("pickupobjects", pick, pick_state, True),
        ("pickupobjects", pick_ss, pick_ss_state, False),
        ("pickupobjects", pick_ss, pick_ss_state, True),
        ("pickupobjects", pick_n, facing_states(pick_n, ent_gen, (0.5, 0.5), (11.5, 11.5)),
         False),
        ("maze8x8-procgen", near_cases[5][1], random_maze_states(near_cases[5][1], ent_gen),
         False)])
    lap("ent-undefined")
    near_launches = phase_nearest_paths(maze_n, hall_n, env, rates)
    lap("main: maze nearest, hallway nearest")
    room_launches, room_errs = phase_continuous(room, env, rates)
    errs = {k: max(v, room_errs.get(k, 0.0)) for k, v in errs.items()}
    lap("main: roomobjects, putnext")
    # the last three ids: CollectHealth's stages, place_one and main path;
    # the camera ids' paths and their extremes
    health = env(HEALTH_ID, B)
    health_errs, health_timings, health_work, health_launches = phase_collecthealth(
        health, maze, rates)
    lap("main: collecthealth")
    # the mesh rows' kernel against its plain version at the mesh paths'
    # batches, one state in nearest mode
    rows_err, rows_timings, rows_work = phase_mesh_rows([
        ("collecthealth", health, True), ("pickupobjects", pick, True), ("sign", sign, True),
        ("pickupobjects nearest", near_cases[1][1], False)])
    lap("mesh-rows")
    cam_launches, overlay = phase_camera(env(CAM_ID, B), env(CLICK_ID, B), rates)
    ext_errs = phase_camera_extremes(env)
    for k, v in list(health_errs.items()) + list(ext_errs.items()):
        errs[k] = max(errs.get(k, 0.0), v)
    lap("main: cameracontrol, cameracontrolclick, camera extremes")
    # the top view: both kernels against their plain versions at B_PLAIN
    # and at the Maze 8x8 procgen top-view main path's shapes, then its
    # main paths; the visibility query at PickupObjects' and the Maze's
    maze_top, pick_top = env(MAZE_ID, B_MAZE, view="top"), env(PICK_ID, B_PICK, view="top")
    top_cases = [("hallway", env(ENV_ID, B_PLAIN, view="top")),
                 ("pickupobjects", env(PICK_ID, B_PLAIN, view="top")),
                 ("fourrooms nearest", env("MiniWorld-FourRooms-v0", B_PLAIN, view="top",
                                           tex_mode="nearest")),
                 ("sign", env(SIGN_ID, B_PLAIN, view="top")),
                 ("maze8x8-procgen", env(MAZE_ID, B_PLAIN, view="top")),
                 # at 96x72 pixel centres fall in the junction strips: the kill decides
                 ("maze8x8-procgen 96x72", MiniWorldVec(MAZE_ID, B_PLAIN, obs_width=96,
                                                        obs_height=72, device=DEVICE,
                                                        view="top")),
                 ("mazes3-bank", env(MAZE_S3_ID, B_PLAIN, view="top", procgen=False))]
    top_err, top_timings, top_work_, top_checked = phase_topview_stages(top_cases, maze_top,
                                                                         pick_top)
    lap("topview-stages")
    vis_gen = torch.Generator().manual_seed(2020)
    vis_err, vis_timings, vis_work_, vis_launches = phase_visible_ents(
        vis_cases(pick, maze, env(THREE_ID, B), vis_gen))
    lap("visible-ents")
    top_launches = phase_topview_paths(maze_top, pick_top, env, rates)
    lap("main: maze top, pickupobjects top, hallway top")
    # scheduled tri_pass: the 8x8 Maze's layout bank at 160x120,
    # supersample=2, B=1024 (packed PVS over 2 chunks of 96), also with
    # domain randomisation, and the tri_chunk=16 routes at B_PLAIN, every
    # SCHED instance against tri_pass_scheduled; then their main paths
    with shared_banks():
        maze_bank, maze_bank_dr = (
            MiniWorldVec(MAZE_ID, B, obs_width=2 * W, obs_height=2 * H, supersample=2,
                         procgen=False, device=DEVICE, domain_rand=dr) for dr in (False, True))
        maze_vis = chunk_vis_env(lambda: MiniWorldVec(
            MAZE_ID, B, obs_width=2 * W, obs_height=2 * H, supersample=2, procgen=False,
            device=DEVICE))
        with transformed_banks(widened):  # its atlas past 256 rows ([f32-dense])
            maze_bank_w = MiniWorldVec(MAZE_ID, B, obs_width=2 * W, obs_height=2 * H,
                                       supersample=2, procgen=False, device=DEVICE,
                                       domain_rand=True)
    if (maze_bank.plan["kind"], maze_bank.tri_chunk, maze_bank.plan["sched_len"]) != (
            "packed_pvs", 96, 2) or maze_vis.plan["kind"] != "chunk_vis":
        raise AssertionError(f"{MAZE_ID} bank B={B} 160x120 ss=2 plans {maze_bank.plan}, "
                             f"{maze_vis.plan['kind']} without the packed planner")
    small = {env_id: env(env_id, B_PLAIN, tri_chunk=16, **kw) for env_id, kw in SCHED_IDS}
    big = {env_id: env(env_id, B, tri_chunk=16, **kw) for env_id, kw in SCHED_IDS}
    four_dr = env(FOUR_ID, B_PLAIN, tri_chunk=16, domain_rand=True)
    sched_gen = torch.Generator().manual_seed(1172)
    sched_cases = [(label, e, view_states(e, sched_gen), B_PLAIN) for label, e in (
        ("fourrooms tri_chunk=16", small[FOUR_ID]),
        ("fourrooms tri_chunk=16 domain_rand", four_dr),
        ("threerooms tri_chunk=16", small[THREE_ID]),
        ("mazes3-bank tri_chunk=16", small[MAZE_S3_ID]),
        ("maze8x8-bank ss=2", maze_bank),
        ("maze8x8-bank ss=2 domain_rand", maze_bank_dr),
        ("maze8x8-bank ss=2 chunk_vis", maze_vis))]
    timed_state, clamped_rooms = clamped_states(maze_bank, view_states(maze_bank, sched_gen))
    timed_dr_state, _ = clamped_states(maze_bank_dr, view_states(maze_bank_dr, sched_gen))
    say("clamped-slots", env=f"{MAZE_ID} bank", layout_room=clamped_rooms,
        envs=8 * len(clamped_rooms))
    lap("sched envs")
    sched_err, sched_timings, sched_work, sched_checked = phase_sched_stages(
        sched_cases, [("maze8x8-bank ss=2", maze_bank, timed_state),
                      ("maze8x8-bank ss=2 domain_rand", maze_bank_dr, timed_dr_state),
                      ("threerooms tri_chunk=16", big[THREE_ID],
                       view_states(big[THREE_ID], sched_gen)),
                      ("maze8x8-bank ss=2 chunk_vis", maze_vis, timed_state)])
    lap("sched-stages")
    sched_launches, bank_ent_err = phase_sched_paths(
        maze_bank, maze_bank_dr, (timed_state, timed_dr_state), big, small, rates)
    errs["entity_pass"] = max(errs["entity_pass"], bank_ent_err)
    lap("main: maze bank ss=2, tri_chunk=16 routes")
    train_launches, train_summary = phase_train(env, smi)
    lap("train: a2c, ppo, gaussian head, sign")
    # the gymnasium adapter on every id, its goldens and frames a second;
    # the layout-bank refresh and the A2C twin refreshing
    gym_launches, gym_err, gym_summary = phase_gym(smi)
    lap("gym: adapter, goldens, fps")
    refresh_launches = phase_refresh()
    lap("refresh: two banks, a2c --refresh-layouts-every 2")
    # the float32 carry above 256 ids and the dense super-bank kill; the
    # manual-control command line on the card
    f32_err, f32_timings, f32_launches, f32_checked = phase_f32_dense(maze, maze_bank_w, env,
                                                                      rates)
    phase_cli(smi)
    lap("cli")
    kernels = []
    for k, (src, rep) in KERNELS.items():
        if k == "entity_mesh_rows":  # its own row below
            continue
        # the Maze path's kernels at its shapes; the mesh pass at
        # PickupObjects': the tri_pass launch with mesh rows there
        mesh = k == "entity_mesh_pass"
        path_timings, path_work, launches = (
            (pick_timings, pick_work, pick_launches) if mesh else
            (health_timings, health_work, health_launches) if k == "place_one" else
            (timings, work, maze_launches))
        bound_ms, bound_by = bound(*path_work[k])
        ms, plain_ms = path_timings["tri_pass" if mesh else k][:2]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": int(launches[k]), "max_abs_err": errs[k],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
        if mesh:  # one launch with tri_pass; that launch without mesh rows beside it
            kernels[-1]["fused_into"] = "tri_pass"
            kernels[-1]["device_ms"] = DEVICE_MS.get(("tri_pass", "mesh"))
            kernels[-1]["tri_pass_unmeshed_ms"] = pick_timings["tri_pass_unmeshed"][0]
            kernels[-1]["tri_pass_unmeshed_bound_ms"] = bound(*pick_work["tri_pass_unmeshed"])[0]
        if k == "place":  # the kernel alone (profiler), and at PickupObjects' shapes;
            # beside each bound, every try of the reference's work counted
            kernels[-1]["device_ms"] = DEVICE_MS.get(("place", MAZE_ID))
            kernels[-1]["bound_all_tries_ms"] = bound(*work["place_all_tries"])[0]
            kernels[-1]["ms_pickupobjects"] = pick_timings["place"][0]
            kernels[-1]["device_ms_pickupobjects"] = DEVICE_MS.get(("place", PICK_ID))
            kernels[-1]["bound_ms_pickupobjects"] = bound(*pick_work["place"])[0]
            kernels[-1]["bound_all_tries_ms_pickupobjects"] = bound(
                *pick_work["place_all_tries"])[0]
        if k == "tri_pass":  # every (row, pixel) pair counted, as before the culling
            kernels[-1]["bound_full_scan_ms"] = bound(*path_work["tri_pass_full_scan"])[0]
        if k == "entity_pass":  # every (sample, active slot) pair counted, as
            # before the cull; at PickupObjects' shapes and at the Maze
            # supersample=2 path's 160x120 samples
            ms, plain_ms, wk, _, full, dev = mss["entity_pass"]
            kernels[-1].update({
                "bound_full_scan_ms": bound(*work["entity_pass_full_scan"])[0],
                "device_ms": timings["entity_pass"][2],
                "ms_pickupobjects": pick_timings["entity_pass"][0],
                "plain_ms_pickupobjects": pick_timings["entity_pass"][1],
                "device_ms_pickupobjects": pick_timings["entity_pass"][2],
                "bound_ms_pickupobjects": bound(*pick_work["entity_pass"])[0],
                "bound_full_scan_ms_pickupobjects": bound(
                    *pick_work["entity_pass_full_scan"])[0],
                "launches_pickupobjects": int(pick_launches["entity_pass"]),
                "ms_maze_ss2": ms, "plain_ms_maze_ss2": plain_ms, "device_ms_maze_ss2": dev,
                "bound_ms_maze_ss2": bound(*wk)[0], "bound_by_maze_ss2": bound(*wk)[1],
                "bound_full_scan_ms_maze_ss2": bound(*full)[0],
                "shapes_maze_ss2": f"{MAZE_ID} procgen supersample=2 B={B_MAZE} "
                                   f"samples={2 * W}x{2 * H}"})
        if k == "mazegen":  # the kernel alone; at one env an SM, the chain's floor
            kernels[-1]["device_ms"] = timings["mazegen"][2]
            kernels[-1]["chain_ms"] = mazegen_chain_ms
        if k == "place_one":  # the kernel alone; at the CollectHealth path's shapes
            kernels[-1]["device_ms"] = health_timings["place_one"][2]
            kernels[-1]["shapes"] = f"{HEALTH_ID} B={health.num_envs} O=19 budget=16"
            kernels[-1]["checked_on"] = [
                "collecthealth step inputs (carrying varied)", "radius scaled to exhaust",
                "budgets 0, 31, 40", f"maze8x8 procgen agent row B={B_MAZE} (= place_all)",
                "pickup step kernels vs plain"]
        if k == "tri_pass":  # with CollectHealth's 864 mesh rows in the launch
            kernels[-1].update({
                "ms_collecthealth_mesh864": health_timings["tri_pass"][0],
                "plain_ms_collecthealth_mesh864": health_timings["tri_pass"][1],
                "device_ms_collecthealth_mesh864": health_timings["tri_pass_device"],
                "bound_ms_collecthealth_mesh864": bound(*health_work["tri_pass"])[0],
                "bound_by_collecthealth_mesh864": bound(*health_work["tri_pass"])[1],
                "launches_collecthealth": int(health_launches["tri_pass"]),
                "entity_mesh_rows_ms_collecthealth": health_timings["entity_mesh_rows"]})
    # the mesh rows at the CollectHealth main path's shapes (launches: its
    # rollouts), PickupObjects' B=4096 and Sign's B=1024 beside them; each
    # path's launches a step (one a render)
    ms, plain_ms, dev_ms = rows_timings["collecthealth"]
    row = {
        "name": "entity_mesh_rows", "route": "cuda", "source": KERNELS["entity_mesh_rows"][0],
        "replaces": KERNELS["entity_mesh_rows"][1],
        "launches": int(health_launches["entity_mesh_rows"]), "max_abs_err": rows_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound(*rows_work["collecthealth"])[0],
        "bound_by": bound(*rows_work["collecthealth"])[1], "library_ms": None,
        "device_ms": dev_ms, "shapes": f"{HEALTH_ID} B={B} E*M=864",
        "launches_per_step": health_launches["entity_mesh_rows"] / (SHORT_HORIZON * TRIALS),
        "checked_on": list(rows_timings) + ["int64 layout ids"]}
    for label, lc, steps in (("pickupobjects", pick_launches, HORIZON * PICK_TRIALS),
                             ("sign", glyph_launches["sign_b1024"], HORIZON * TRIALS)):
        row.update({f"ms_{label}": rows_timings[label][0],
                    f"plain_ms_{label}": rows_timings[label][1],
                    f"device_ms_{label}": rows_timings[label][2],
                    f"bound_ms_{label}": bound(*rows_work[label])[0],
                    f"launches_{label}": int(lc["entity_mesh_rows"]),
                    f"launches_per_step_{label}": lc["entity_mesh_rows"] / steps})
    kernels.append(row)
    # the multi-chunk kernel at the Sidewalk main path's shapes (3 chunks
    # of 1,024); its paired launch is tri_pass_paired_chunks below
    from miniworld_tpu_torch.render import raycast as rc

    gx, gy, window_rows = rc.tri_pass_window()
    kernels.append({
        "name": "tri_pass_multi", "route": "cuda", "source": KERNELS["tri_pass"][0],
        "replaces": "miniworld_tpu/render/raycast.py:444",
        "launches": int(side_launches["tri_pass_multi"]), "max_abs_err": side_errs["tri_pass"],
        "ms": side_timings["tri_pass"][0], "plain_ms": side_timings["tri_pass"][1],
        "bound_ms": bound(*side_work["tri_pass"])[0],
        "bound_by": bound(*side_work["tri_pass"])[1], "library_ms": None,
        "instance_of": "tri_pass", "shapes": f"{SIDE_ID} B={B} HW={W * H} S=3072 tri_chunk=1024",
        "bound_full_scan_ms": bound(*side_work["tri_pass_full_scan"])[0],
        "group_of_tiles": f"{gx}x{gy}", "window_rows": window_rows,
        "checked_on": ["sidewalk B=64 (1024, 496, 16) and B=1024 (+override, f32)",
                       "wallgap", "ties", "overflow S=4096 (1024, 1000)", "paired (below)",
                       "nearest sidewalk, maze ss=2 (f32)"]})
    # the texture-variant override (an instance of tri_pass) at the Maze
    # 8x8 procgen and FourRooms domain_rand main paths' shapes, beside the
    # same launch without the key; the SS=2 epilogue at PickupObjects' and
    # Hallway's supersample=2 main paths' shapes
    ov, ov4 = dr_timings["maze8x8-procgen"], dr_timings["fourrooms"]
    kernels.append({
        "name": "tri_pass_override", "route": "cuda", "source": KERNELS["tri_pass"][0],
        "replaces": "miniworld_tpu/render/raycast.py:277",
        "launches": int(new_launches[MAZE_ID, "dr"]["tri_pass_override"]), "max_abs_err": dr_err,
        "ms": ov["override"][0], "plain_ms": ov["override"][1],
        "bound_ms": bound(*dr_work["maze8x8-procgen"])[0],
        "bound_by": bound(*dr_work["maze8x8-procgen"])[1], "library_ms": None,
        "instance_of": "tri_pass", "shapes": f"{MAZE_ID} procgen domain_rand B={B_MAZE} HW={W * H}",
        "ms_without_override": ov["unkeyed"][0],
        "ms_fourrooms": ov4["override"][0], "plain_ms_fourrooms": ov4["override"][1],
        "ms_fourrooms_without_override": ov4["unkeyed"][0],
        "bound_ms_fourrooms": bound(*dr_work["fourrooms"])[0],
        "launches_fourrooms": int(
            new_launches["MiniWorld-FourRooms-v0", "dr"]["tri_pass_override"]),
        "checked_on": [r[0] for r in routes]})
    kernels.append({
        "name": "pixel_epilogue_ss2", "route": "cuda", "source": KERNELS["pixel_epilogue"][0],
        "replaces": "miniworld_tpu/render/raycast.py:1294",
        "launches": int(new_launches[PICK_ID, "ss2"]["pixel_epilogue_ss2"]),
        "max_abs_err": max(ss_err, mss["pixel_epilogue_ss2"][3]),
        "ms": ss_timings["pickupobjects"][0], "plain_ms": ss_timings["pickupobjects"][1],
        "bound_ms": bound(*ss_work["pickupobjects"])[0],
        "bound_by": bound(*ss_work["pickupobjects"])[1], "library_ms": None,
        "instance_of": "pixel_epilogue",
        "shapes": f"{PICK_ID} supersample=2 B={B_PICK} out={W}x{H}",
        "issue_floor_ms": ss_floors["pickupobjects"],
        "instructions_a_term": sass_term_instructions(16, False),
        "ms_maze_ss2": mss["pixel_epilogue_ss2"][0],
        "plain_ms_maze_ss2": mss["pixel_epilogue_ss2"][1],
        "bound_ms_maze_ss2": bound(*mss["pixel_epilogue_ss2"][2])[0],
        "bound_by_maze_ss2": bound(*mss["pixel_epilogue_ss2"][2])[1],
        "issue_floor_ms_maze_ss2": mss["pixel_epilogue_ss2"][4],
        "launches_maze_ss2": int(
            glyph_launches["maze8x8_procgen_ss2_b8192"]["pixel_epilogue_ss2"]),
        "shapes_maze_ss2": f"{MAZE_ID} procgen supersample=2 B={B_MAZE} out={W}x{H}",
        "ms_hallway": ss_timings["hallway"][0], "plain_ms_hallway": ss_timings["hallway"][1],
        "bound_ms_hallway": bound(*ss_work["hallway"])[0],
        "launches_hallway": int(new_launches[ENV_ID, "ss2"]["pixel_epilogue_ss2"]),
        "checked_on": ["hallway", "pickupobjects", f"maze8x8 procgen B={B_MAZE} 80x60",
                       f"maze8x8-bank B={B} 160x120", f"maze8x8-bank domain_rand B={B} 160x120"]})
    # Sign's glyph epilogue (an instance of pixel_epilogue) at its main
    # path's shapes, SS=1, and at SS=2 beside it; the paired tri_pass over
    # the clamped second chunk at the Maze 8x8 procgen supersample=2 path's
    kernels.append({
        "name": "pixel_epilogue_gain", "route": "cuda", "source": KERNELS["pixel_epilogue"][0],
        "replaces": "miniworld_tpu/render/raycast.py:656",
        "launches": int(glyph_launches["sign_b1024"]["pixel_epilogue_gain"]),
        "max_abs_err": gain_err, "ms": gain_timings[1][0], "plain_ms": gain_timings[1][1],
        "bound_ms": bound(*gain_work[1])[0], "bound_by": bound(*gain_work[1])[1],
        "library_ms": None, "instance_of": "pixel_epilogue",
        "shapes": f"{SIGN_ID} B={B} out={W}x{H} K=64", "glyph_samples": glyphs[1],
        "ms_ss2": gain_timings[2][0], "plain_ms_ss2": gain_timings[2][1],
        "bound_ms_ss2": bound(*gain_work[2])[0], "glyph_samples_ss2": glyphs[2],
        "issue_floor_ms_ss2": gain_work["floor"],
        "instructions_a_term_ss2": sass_term_instructions(64, True),
        "checked_on": ["sign SS=1", "sign SS=2"]})
    kernels.append({
        "name": "tri_pass_paired_chunks", "route": "cuda", "source": KERNELS["tri_pass"][0],
        "replaces": "miniworld_tpu/render/raycast.py:252",
        "launches": int(glyph_launches["maze8x8_procgen_ss2_b8192"]["tri_pass_paired_chunks"]),
        "max_abs_err": pc_err, "ms": pc_timings[0], "plain_ms": pc_timings[1],
        "bound_ms": bound(*pc_work)[0], "bound_by": bound(*pc_work)[1], "library_ms": None,
        "instance_of": "tri_pass",
        "shapes": f"{MAZE_ID} procgen supersample=2 B={B_MAZE} samples={2 * W}x{2 * H} "
                  "Sp=608 chunks 0-495, 112-607",
        "checked_on": ["maze8x8 procgen ss=2", "override", "paired ties"]})
    # nearest mode: the F32 tri_pass (the float32 attribute carry) and the
    # NEAREST epilogue (F32 load) at the Maze 8x8 procgen nearest main
    # path's shapes, the F32 tri_pass beside the same launch in bf16
    for name, replaces, extra in (
            ("tri_pass_f32", "miniworld_tpu/render/raycast.py:512",
             {"instance_of": "tri_pass",
              "ms_bf16_same_rows": near_timings["tri_pass_bf16"][0],
              "bound_ms_bf16_same_rows": bound(*near_work["tri_pass_bf16"])[0]}),
            ("pixel_epilogue_nearest", "miniworld_tpu/render/raycast.py:727",
             {"instance_of": "pixel_epilogue",
              "launches_f32": int(near_launches["pixel_epilogue_f32"])})):
        ms, plain_ms = near_timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNELS[extra["instance_of"]][0],
            "replaces": replaces, "launches": int(near_launches[name]),
            "max_abs_err": near_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound(*near_work[name])[0], "bound_by": bound(*near_work[name])[1],
            "library_ms": None, **extra,
            "shapes": f"{MAZE_ID} procgen nearest B={B_MAZE} HW={W * H} T=528",
            "checked_on": [k for k, f32 in near_checked.items()
                           if f32 or name == "pixel_epilogue_nearest"]})
    # the top view's kernels at the Maze 8x8 procgen top-view main path's
    # shapes (launches: its rollouts), the visibility query at the Maze's
    # B=8192 (launches: its path) beside PickupObjects' B=4096
    for name in ("tri_pass_ortho", "topview_epilogue"):
        ms, plain_ms = top_timings[name]
        row = {
            "name": name, "route": "cuda", "source": TOP_KERNELS[name][0],
            "replaces": TOP_KERNELS[name][1], "launches": int(top_launches["maze"][name]),
            "max_abs_err": top_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound(*top_work_[name])[0], "bound_by": bound(*top_work_[name])[1],
            "library_ms": None,
            "shapes": f"{MAZE_ID} procgen view=top B={B_MAZE} HW={W * H}",
            "launches_pickupobjects_b4096": int(top_launches["pick"][name]),
            "checked_on": top_checked}
        if name == "tri_pass_ortho":
            row["bound_full_scan_ms"] = bound(*top_work_["tri_pass_ortho_full_scan"])[0]
        else:
            row["issue_floor_ms"], row["instructions_a_term"] = top_work_[
                "topview_epilogue_floor"]
        kernels.append(row)
    ms, plain_ms, dev_ms = vis_timings["maze8x8-procgen"]
    kernels.append({
        "name": "visible_ents", "route": "cuda", "source": TOP_KERNELS["visible_ents"][0],
        "replaces": TOP_KERNELS["visible_ents"][1],
        "launches": int(vis_launches["maze8x8-procgen"]["visible_ents"]), "max_abs_err": vis_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound(*vis_work_["maze8x8-procgen"][0])[0],
        "bound_by": bound(*vis_work_["maze8x8-procgen"][0])[1], "library_ms": None,
        "device_ms": dev_ms,
        "bound_full_scan_ms": bound(*vis_work_["maze8x8-procgen"][1])[0],
        "shapes": f"{MAZE_ID} procgen B={B_MAZE} HW={W * H}",
        "ms_pickupobjects_b4096": vis_timings["pickupobjects"][0],
        "device_ms_pickupobjects_b4096": vis_timings["pickupobjects"][2],
        "plain_ms_pickupobjects_b4096": vis_timings["pickupobjects"][1],
        "bound_ms_pickupobjects_b4096": bound(*vis_work_["pickupobjects"][0])[0],
        "bound_full_scan_ms_pickupobjects_b4096": bound(*vis_work_["pickupobjects"][1])[0],
        "launches_pickupobjects_b4096": int(vis_launches["pickupobjects"]["visible_ents"]),
        "checked_on": list(vis_timings)})
    # the scheduled tri_pass (SCHED) at the Maze bank ss=2 main path's shapes
    # (its mesh-seeded instance at ThreeRooms tri_chunk=16 beside it)
    ms, plain_ms = sched_timings["maze8x8-bank ss=2"]
    mesh_ms, mesh_plain_ms = sched_timings["threerooms tri_chunk=16"]
    mesh_work = sched_work["threerooms tri_chunk=16"]
    kernels.append({
        "name": "tri_pass_sched", "route": "cuda", "source": KERNELS["tri_pass"][0],
        "replaces": "miniworld_tpu/render/raycast.py:1166",
        "launches": int(sched_launches["maze_bank"]["tri_pass_sched"]), "max_abs_err": sched_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound(*sched_work["maze8x8-bank ss=2"])[0],
        "bound_by": bound(*sched_work["maze8x8-bank ss=2"])[1], "library_ms": None,
        "instance_of": "tri_pass",
        "shapes": f"{MAZE_ID} bank supersample=2 B={B} samples={4 * W}x{4 * H} "
                  "packed PVS, 2 chunks of 96",
        "launches_override_maze_bank_dr": int(
            sched_launches["maze_bank_dr"]["tri_pass_override"]),
        "ms_override_maze_bank_dr": sched_timings["maze8x8-bank ss=2 domain_rand"][0],
        "plain_ms_override_maze_bank_dr": sched_timings["maze8x8-bank ss=2 domain_rand"][1],
        "bound_ms_override_maze_bank_dr": bound(
            *sched_work["maze8x8-bank ss=2 domain_rand"])[0],
        "ms_mesh_threerooms": mesh_ms, "plain_ms_mesh_threerooms": mesh_plain_ms,
        "bound_ms_mesh_threerooms": bound(*mesh_work)[0],
        "bound_by_mesh_threerooms": bound(*mesh_work)[1],
        "launches_mesh_threerooms": int(
            sched_launches[f"threerooms_tri_chunk16_b{B}"]["entity_mesh_pass"]),
        "ms_chunk_vis": sched_timings["maze8x8-bank ss=2 chunk_vis"][0],
        "plain_ms_chunk_vis": sched_timings["maze8x8-bank ss=2 chunk_vis"][1],
        "bound_ms_chunk_vis": bound(*sched_work["maze8x8-bank ss=2 chunk_vis"])[0],
        "shapes_chunk_vis": f"{MAZE_ID} bank supersample=2 B={B}, the packed planner off: "
                            f"chunk_vis, {maze_vis.plan['sched_len']} chunks of "
                            f"{maze_vis.tri_chunk}",
        "checked_on": sched_checked})
    kernels += f32_kernel_rows(f32_err, f32_timings, f32_launches, f32_checked)
    kernels[KERNEL_ORDER["place"]]["launches_roomobjects"] = int(room_launches["place"])
    for k in kernels:  # the adapter's path (every id, B=1) and the refreshed banks' rollouts
        k["launches_gym"] = int(gym_launches.get(k["name"], 0))
        if k["launches_gym"]:
            k["max_abs_err"] = max(k["max_abs_err"], gym_err)
        k["launches_refresh"] = {label: int(ln[k["name"]])
                                 for label, ln in refresh_launches.items() if ln.get(k["name"])}
    for k in kernels:  # each train step's rollout launches the render's kernels
        for label, ln in train_launches.items():
            if ln.get(k["name"]):
                k[f"launches_train_{label}"] = int(ln[k["name"]])
    for k in kernels:  # what each kernel was held against its plain version on
        if k["name"] == "tri_pass":
            k["checked_on"] = ["single chunk", "mesh rows: pickupobjects, roomobjects", "paired",
                               "multi-chunk", "packed PVS", "grazing", "ties",
                               "override: " + ", ".join(r[0] for r in routes),
                               "paired multi-chunk: maze8x8 ss=2, paired ties",
                               "nearest, local slots: " + ", ".join(
                                   k for k, f32 in near_checked.items() if not f32),
                               "sched: " + ", ".join(sched_checked),
                               f"mesh rows: collecthealth B={B} (864 a render)",
                               f"cameracontrol extremes B={B_EXT} SS=1, SS=2"]
        elif k["name"] == "pixel_epilogue":
            k["checked_on"] = ["SS=1: hallway, wide, pickupobjects, maze, sidewalk, roomobjects",
                               "SS=2: hallway, pickupobjects, maze8x8-bank (+domain_rand) "
                               f"B={B} 160x120", "GAIN SS=1, SS=2: sign",
                               "NEAREST: " + ", ".join(near_checked),
                               f"SS=1: collecthealth B={B}",
                               f"SS=1, SS=2: cameracontrol extremes B={B_EXT}"]
        elif k["name"] == "entity_pass":
            k["checked_on"] = ["hallway", "wide", "pickupobjects", "wide-mesh",
                               "maze8x8 procgen", f"maze8x8 procgen ss=2 B={B_MAZE} 160x120 "
                               "samples", "sidewalk", "roomobjects",
                               f"maze8x8-bank (+domain_rand) ss=2 B={B} 320x240 samples",
                               f"cameracontrol extremes B={B_EXT} 80x60, 160x120 samples"]
        elif k["name"] == "place":
            k["checked_on"] = ["pickupobjects", "fourrooms", "roomobjects (budget 48)",
                               "maze8x8 procgen", "radius scaled", "budgets 0, 30, 31, 40, 48"]
    print(json.dumps({
        "kernels": kernels,
        # no kernel: one torch.where over the frame (CameraControl's crosshair)
        "overlays": [{"name": "crosshair", "route": "torch.where",
                      "source": "miniworld_tpu_torch/envs/cameracontrol.py",
                      "replaces": "miniworld_tpu/envs/cameracontrol.py:57",
                      "ms": overlay[0], "bound_ms": overlay[1], "bound_by": "bytes",
                      "shapes": f"{CAM_ID} B={B} {W}x{H}",
                      "applied": "once an observation (reset, step, rollout)",
                      "paths": sorted(cam_launches)}],
        "env_steps_per_s": {k: {"kernels": v[0], "plain": v[1]} for k, v in rates.items()},
        "train": train_summary,
        "gym": dict(gym_summary, card=smi),
    }))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
