"""Interactive controller (reference: miniworld/manual_control.py).

Same capabilities as the reference's pyglet event loop — WASD/arrow
movement, mouse-look with sensitivity and deadzone, pitch control,
pickup/drop keys, continuous->discrete action projection, episode
recording to LeRobot datasets with auto-split, top-view toggle — built
on pygame (the reference's pyglet is a GL binding; this engine has no
GL dependency to piggyback on).

Also provides a headless ``ScriptedControl`` driver (random or callable
policy) so recording works without a display — the piece of the
reference workflow that actually matters for dataset generation.

The PyTorch port's copy of ``miniworld_tpu/manual_control.py``, over the
port's gymnasium adapter (gym_env.py), hud and LeRobot writer, and the
command line of ``scripts/manual_control.py`` (``main``)::

    python -m miniworld_tpu_torch.manual_control MiniWorld-Hallway-v0
    python -m miniworld_tpu_torch.manual_control MiniWorld-OneRoom-v0 --headless \
        --steps 500 --record-dir /tmp/ds    # no display needed

Frames render on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Callable, Optional

import numpy as np

from miniworld_tpu_torch.io.lerobot import DatasetManager, EpisodeWriter, build_state_vector

MOUSE_SENSITIVITY = 0.15  # deg per pixel (manual_control.py:240-265)
MOUSE_DEADZONE = 1  # pixels


def project_discrete(action_vec: np.ndarray, table: np.ndarray) -> int:
    """Continuous -> discrete: the largest-magnitude matching component
    wins (manual_control.py:650-694)."""
    best, best_mag = 0, 0.0
    for idx, row in enumerate(table):
        comp = np.argmax(np.abs(row))
        if row[comp] == 0:
            continue
        mag = action_vec[comp] * np.sign(row[comp])
        if mag > best_mag:
            best, best_mag = idx, mag
    return best


class Recorder:
    """Episode recording with auto-split on done (manual_control.py:460-505)."""

    def __init__(self, out_dir: str, fps: int = 30, append: bool = True,
                 task: str = "miniworld"):
        self.manager = DatasetManager(out_dir, fps=fps, append=append,
                                      default_task=task)
        self.writer: Optional[EpisodeWriter] = None
        self.enabled = False

    def start(self):
        self.enabled = True
        self.writer = EpisodeWriter(self.manager)

    def add(self, frame, action, info, reward=0.0, done=False):
        if not self.enabled or self.writer is None:
            return
        self.writer.add_sample(
            frame, np.asarray(action, np.float32),
            state=build_state_vector(info), reward=reward, done=done,
        )
        if done:
            self.split()

    def split(self):
        if self.writer is not None and self.writer.num_frames:
            self.writer.close()
        self.writer = EpisodeWriter(self.manager) if self.enabled else None

    def stop(self):
        if self.writer is not None and self.writer.num_frames:
            self.writer.close()
        self.writer = None
        self.enabled = False
        self.manager.finalize()


class ScriptedControl:
    """Headless driver: run a policy, optionally record (no display)."""

    def __init__(self, env, policy: Callable | str = "random",
                 record_dir: str | None = None, fps: int = 30):
        self.env = env
        self.policy = policy
        self.recorder = Recorder(record_dir, fps=fps) if record_dir else None

    def run(self, num_steps: int = 1000, seed: int = 0):
        obs, info = self.env.reset(seed=seed)
        if self.recorder:
            self.recorder.start()
        for t in range(num_steps):
            if self.policy == "random":
                action = self.env.action_space.sample()
            else:
                action = self.policy(obs)
            obs, reward, term, trunc, info = self.env.step(action)
            frame = obs["obs"] if isinstance(obs, dict) else obs
            if self.recorder:
                self.recorder.add(frame, np.asarray(action, np.float32).reshape(-1),
                                  info, reward, term or trunc)
            if term or trunc:
                obs, info = self.env.reset()
        if self.recorder:
            self.recorder.stop()


class ManualControl:
    """pygame interactive loop (reference ManualControl parity).

    Keys: WASD/arrows move+turn, Q/E strafe, R/F pitch, P pickup,
    O drop, T top view, G record toggle, ESC quit. Mouse-look when the
    pointer is grabbed (click window to grab, ESC releases).
    """

    def __init__(self, env, record_dir: str | None = None, fps: int = 30,
                 top_view: bool = False, window_scale: int = 6,
                 show_hud: bool = True, show_controls: bool | None = None,
                 mouse_sensitivity: float = MOUSE_SENSITIVITY,
                 fullscreen: bool = False,
                 window_size: tuple[int, int] | None = None,
                 mouse_recenter: bool = True,
                 automatic_recording: bool = False,
                 task: str = "miniworld", append: bool = True):
        self.env = env
        self.fps = fps
        self.top_view = top_view
        self.show_hud = show_hud
        self.show_controls_override = show_controls
        self.mouse_sensitivity = mouse_sensitivity
        self.fullscreen = fullscreen
        self.window_size = window_size
        # --no-mouse-recenter parity (scripts/manual_control.py:111-117):
        # leave the cursor free instead of grabbing it for mouse-look
        self.mouse_recenter = mouse_recenter
        self.automatic_recording = automatic_recording
        self.recorder = (
            Recorder(record_dir, fps=fps, append=append, task=task)
            if record_dir else None
        )
        u = env.unwrapped if hasattr(env, "unwrapped") else env
        self.uenv = u
        self.click_env = getattr(u.spec_def, "click_action", False)
        self.discrete = getattr(u, "_discrete_actions", None)

    def run(self, seed: int = 0):
        import pygame

        pygame.init()
        env = self.env
        obs, info = env.reset(seed=seed)
        u = self.uenv
        if self.show_controls_override is not None:
            u.show_controls = self.show_controls_override
        if self.fullscreen:
            # --fullscreen parity (scripts/manual_control.py:36-40)
            screen = pygame.display.set_mode((0, 0), pygame.FULLSCREEN)
            w, h = screen.get_size()
        else:
            if self.window_size is not None:
                # --window-size WxH (scripts/manual_control.py:41-49)
                w, h = self.window_size
            else:
                w = u.obs_width * self.window_scale
                h = u.obs_height * self.window_scale
            screen = pygame.display.set_mode((w, h))
        pygame.display.set_caption(f"miniworld-tpu: {u.spec_def.name}")
        clock = pygame.time.Clock()
        grabbed = False
        running = True
        pending_yaw = pending_pitch = 0.0
        if self.recorder and self.automatic_recording:
            # --automatic-recording (scripts/manual_control.py:97-101):
            # start immediately; episodes auto-split on done
            self.recorder.start()

        while running:
            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    running = False
                elif event.type == pygame.KEYDOWN:
                    if event.key == pygame.K_ESCAPE:
                        if grabbed:
                            grabbed = False
                            pygame.event.set_grab(False)
                            pygame.mouse.set_visible(True)
                        else:
                            running = False
                    elif event.key == pygame.K_t:
                        self.top_view = not self.top_view
                    elif event.key == pygame.K_g and self.recorder:
                        if self.recorder.enabled:
                            self.recorder.stop()
                        else:
                            self.recorder.start()
                    elif event.key == pygame.K_BACKSPACE:
                        obs, info = env.reset()
                elif event.type == pygame.MOUSEBUTTONDOWN:
                    if self.click_env:
                        mx, my = event.pos
                        action = np.array([mx / w, my / h], np.float32)
                        obs, r, term, trunc, info = env.step(action)
                        continue
                    # clickable HUD buttons (manual_control.py:515-531)
                    from miniworld_tpu_torch import hud

                    mx, my = event.pos
                    name = hud.hit_test(
                        u.control_boxes,
                        int(mx / self.window_scale),
                        int(my / self.window_scale),
                    )
                    if name is not None:
                        act = u.control_action(name)
                        if act is not None:
                            obs, r, term, trunc, info = env.step(act)
                            if term or trunc:
                                obs, info = env.reset()
                        continue
                    grabbed = True
                    if self.mouse_recenter:
                        pygame.event.set_grab(True)
                        pygame.mouse.set_visible(False)
                elif event.type == pygame.MOUSEMOTION and grabbed:
                    dx, dy = event.rel
                    if abs(dx) > MOUSE_DEADZONE:
                        pending_yaw -= dx * self.mouse_sensitivity
                    if abs(dy) > MOUSE_DEADZONE:
                        pending_pitch -= dy * self.mouse_sensitivity

            keys = pygame.key.get_pressed()
            vec = np.zeros(6, np.float32)
            if keys[pygame.K_w] or keys[pygame.K_UP]:
                vec[0] += 1.0
            if keys[pygame.K_s] or keys[pygame.K_DOWN]:
                vec[0] -= 1.0
            if keys[pygame.K_q]:
                vec[1] -= 1.0
            if keys[pygame.K_e]:
                vec[1] += 1.0
            if keys[pygame.K_a] or keys[pygame.K_LEFT]:
                vec[2] -= 1.0
            if keys[pygame.K_d] or keys[pygame.K_RIGHT]:
                vec[2] += 1.0
            if keys[pygame.K_r]:
                vec[3] += 1.0
            if keys[pygame.K_f]:
                vec[3] -= 1.0
            if keys[pygame.K_p]:
                vec[4] = 1.0
            if keys[pygame.K_o]:
                vec[5] = 1.0

            # out-of-band fractional mouse yaw/pitch applied directly,
            # like the reference (manual_control.py:696-732)
            if (pending_yaw or pending_pitch) and not self.uenv.spec_def.override_physics:
                u._update_agent_orientation(
                    math.radians(pending_yaw), pending_pitch
                )
                pending_yaw = pending_pitch = 0.0

            if np.any(vec != 0) or not self.click_env:
                if self.discrete is not None:
                    action = project_discrete(vec, self.discrete)
                else:
                    action = vec
                obs, reward, term, trunc, info = env.step(action)
                frame = obs["obs"] if isinstance(obs, dict) else obs
                if self.recorder:
                    self.recorder.add(
                        frame,
                        vec if self.discrete is None else np.asarray(
                            self.discrete[action], np.float32),
                        info, reward, term or trunc,
                    )
                if term or trunc:
                    obs, info = env.reset()

            frame = obs["obs"] if isinstance(obs, dict) else obs
            from miniworld_tpu_torch import hud

            if self.top_view:
                frame = u.render_top_view(u.obs_width, u.obs_height)
            elif self.show_hud:
                # reference-style human view: top-view thumbnail + pose
                tv = u.render_top_view(u.obs_width // 2, u.obs_height // 2)
                frame = hud.compose_human_frame(
                    frame, tv,
                    (u.agent_pos[0], u.agent_pos[2], u.agent_dir),
                )
            if u.show_controls:
                frame = hud.draw_controls(frame, u.control_boxes)
            surf = pygame.surfarray.make_surface(
                np.transpose(frame, (1, 0, 2))
            )
            surf = pygame.transform.scale(surf, (w, h))
            screen.blit(surf, (0, 0))
            pygame.display.flip()
            clock.tick(self.fps)

        if self.recorder and self.recorder.enabled:
            self.recorder.stop()
        pygame.quit()


def random_policy(env, seed: int = 0) -> Callable:
    """A uniform random policy over the env's actions, for an env without
    ``action_space`` (``gym_env.SingleEnv`` where gymnasium is absent):
    an index of its discrete table, a click in [0, 1]^2, or a 6-D vector
    in the action box (miniworld.py:483-487)."""
    u = env.unwrapped if hasattr(env, "unwrapped") else env
    spec = u.spec_def
    rng = np.random.default_rng(seed)
    if u._discrete_actions is not None or getattr(spec, "num_actions", 0):
        n = len(u._discrete_actions) if u._discrete_actions is not None else spec.num_actions
        return lambda obs: int(rng.integers(n))
    if getattr(spec, "click_action", False):
        return lambda obs: rng.uniform(0.0, 1.0, 2).astype(np.float32)
    low = np.array([-1, -1, -1, -1, 0, 0], np.float32)
    return lambda obs: rng.uniform(low, 1.0).astype(np.float32)


def main(argv=None):
    """The command line of the JAX package's ``scripts/manual_control.py``
    (reference: scripts/manual_control.py:16-160), every flag of it, over
    the port: ``MiniWorldGym`` (``SingleEnv`` where gymnasium is absent)
    on ``--device`` (the CUDA card by default), ``ScriptedControl`` with
    ``--headless``, else the pygame ``ManualControl``."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # both the positional form and the reference's --env-name flag
    p.add_argument("env_name", nargs="?", default=None)
    p.add_argument("--env-name", dest="env_name_flag", default=None)
    p.add_argument("--domain-rand", action="store_true", help="enable domain randomization")
    p.add_argument("--no-time-limit", action="store_true", help="ignore time step limits")
    p.add_argument("--top-view", "--top_view", action="store_true", dest="top_view",
                   help="show the top view instead of the agent view")
    p.add_argument("--mouse-sensitivity", type=float, default=0.15,
                   help="mouse sensitivity for yaw/pitch, degrees per pixel")
    p.add_argument("--fullscreen", action="store_true", help="start the viewer in fullscreen")
    p.add_argument("--window-size", type=str, default=None,
                   help="initial window size as WIDTHxHEIGHT; ignored with --fullscreen")
    p.add_argument("--hide-hud", action="store_true", help="run the viewer without the HUD")
    p.add_argument("--show-controls", dest="show_controls", default=None, action="store_true",
                   help="enable the on-screen movement/look buttons")
    p.add_argument("--no-show-controls", dest="show_controls", action="store_false",
                   help="disable the on-screen movement/look buttons")
    p.add_argument("--task", type=str, default="Center and zoom on the target.",
                   help="task description recorded in tasks.parquet")
    p.add_argument("--append", action="store_true",
                   help="append recorded episodes to an existing dataset")
    p.add_argument("--automatic-recording", action="store_true",
                   help="start recording immediately, auto-split episodes")
    p.add_argument("--no-mouse-recenter", action="store_true",
                   help="disable mouse cursor grab/re-centering")
    p.add_argument("--obs-width", type=int, default=512)
    p.add_argument("--obs-height", type=int, default=512)
    p.add_argument("--window-scale", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--record-dir", type=str, default=None)
    p.add_argument("--record-fps", type=int, default=30)
    p.add_argument("--headless", action="store_true", help="scripted random policy, no display")
    p.add_argument("--steps", type=int, default=1000, help="steps for --headless mode")
    p.add_argument("--device", default="cuda",
                   help="torch device the frames render on (cuda, or cpu)")
    args = p.parse_args(argv)
    env_name = args.env_name_flag or args.env_name or "MiniWorld-Hallway-v0"

    from miniworld_tpu_torch import gym_env

    cls = gym_env.MiniWorldGym if gym_env.gym is not None else gym_env.SingleEnv
    env = cls(env_name.replace("MiniWorld-", "").replace("-v0", ""),
              obs_width=args.obs_width, obs_height=args.obs_height,
              domain_rand=args.domain_rand,
              max_episode_steps=10**9 if args.no_time_limit else None, device=args.device)

    if args.headless:
        policy = "random" if hasattr(env, "action_space") else random_policy(env, args.seed)
        ScriptedControl(env, policy, args.record_dir,
                        fps=args.record_fps).run(args.steps, seed=args.seed)
        print(f"ran {args.steps} steps on {env.device}"
              + (f"; dataset at {args.record_dir}" if args.record_dir else ""))
        return

    window_size = None
    if args.window_size:
        ww, wh = args.window_size.lower().split("x")
        window_size = (int(ww), int(wh))
    ManualControl(env, record_dir=args.record_dir, fps=args.record_fps,
                  top_view=args.top_view, window_scale=args.window_scale,
                  show_hud=not args.hide_hud, show_controls=args.show_controls,
                  mouse_sensitivity=args.mouse_sensitivity, fullscreen=args.fullscreen,
                  window_size=window_size, mouse_recenter=not args.no_mouse_recenter,
                  automatic_recording=args.automatic_recording, task=args.task,
                  append=args.append).run(seed=args.seed)


if __name__ == "__main__":
    main()
