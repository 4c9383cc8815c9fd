"""The port's manual-control command line (``python -m
miniworld_tpu_torch.manual_control``) against the JAX package's
``scripts/manual_control.py`` on the CPU: every flag of the JAX CLI
reaches the viewer (tests/test_periphery.py::test_manual_control_cli_flags
over the port), and a headless run records the LeRobot dataset the JAX
CLI's headless run records for the same flags (its ``total_frames``);
without gymnasium (the card's image) it steps ``SingleEnv`` with its own
random policy.
"""

import importlib.util
import json
import os
import sys
from unittest import mock

import numpy as np
import pytest

from miniworld_tpu_torch import gym_env
from miniworld_tpu_torch import manual_control as tmc

from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)


def _jax_cli():
    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "manual_control.py")
    spec = importlib.util.spec_from_file_location("mc_cli_jax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_manual_control_cli_flags():
    """Every flag of the JAX CLI parses and reaches ManualControl (no
    display started); --device cpu renders on the CPU."""
    argv = ["--env-name", "MiniWorld-OneRoomS6Fast-v0",
            "--no-time-limit", "--mouse-sensitivity", "0.2",
            "--fullscreen", "--window-size", "640x480", "--hide-hud",
            "--no-show-controls", "--task", "t", "--append",
            "--automatic-recording", "--no-mouse-recenter",
            "--obs-width", "32", "--obs-height", "24", "--seed", "3", "--device", "cpu",
            "--top-view", "--window-scale", "2", "--record-fps", "12", "--domain-rand"]
    with mock.patch("miniworld_tpu_torch.manual_control.ManualControl") as mc:
        tmc.main(argv)
    (env_arg,), kw = mc.call_args
    assert env_arg.max_episode_steps == 10**9          # --no-time-limit
    assert env_arg.device.type == "cpu" and env_arg.domain_rand
    assert (env_arg.obs_width, env_arg.obs_height) == (32, 24)
    assert kw["mouse_sensitivity"] == 0.2
    assert kw["fullscreen"] and kw["window_size"] == (640, 480)
    assert kw["show_hud"] is False and kw["show_controls"] is False
    assert kw["mouse_recenter"] is False
    assert kw["automatic_recording"] and kw["append"]
    assert kw["task"] == "t" and kw["top_view"] and kw["window_scale"] == 2 and kw["fps"] == 12
    mc.return_value.run.assert_called_once_with(seed=3)
    # the positional id, and --device's default: the card
    with mock.patch("miniworld_tpu_torch.manual_control.ManualControl"), \
            mock.patch.object(gym_env.SingleEnv, "__init__", side_effect=RuntimeError("card")) \
            as init:
        with pytest.raises(RuntimeError, match="card"):
            tmc.main(["MiniWorld-Hallway-v0"])
    assert init.call_args.kwargs["device"] == "cuda" and init.call_args.args[1] == "Hallway"


def test_headless_record_matches_jax(tmp_path):
    """A headless 25-step run at 48x36 with --record-dir: the port's
    dataset has the total_frames of the JAX CLI's headless run on the
    same flags."""
    pytest.importorskip("pyarrow")
    flags = ["MiniWorld-OneRoomS6Fast-v0", "--headless", "--steps", "25", "--obs-width", "48",
             "--obs-height", "36"]
    tmc.main(flags + ["--record-dir", str(tmp_path / "port"), "--device", "cpu"])
    with mock.patch.object(sys, "argv", ["prog"] + flags
                           + ["--record-dir", str(tmp_path / "jax")]):
        _jax_cli().main()
    port = json.loads((tmp_path / "port" / "meta" / "info.json").read_text())
    jax_ = json.loads((tmp_path / "jax" / "meta" / "info.json").read_text())
    # the random policies draw from other generators: the episodes split
    # at other steps, the frames are the same
    assert port["total_frames"] == jax_["total_frames"] == 25


def test_headless_without_gymnasium(monkeypatch, capsys):
    """Where gymnasium is absent the CLI steps ``SingleEnv`` with
    ``random_policy``: discrete indices in the table, clicks in [0, 1]^2
    and vectors in the action box."""
    monkeypatch.setattr(gym_env, "gym", None)
    tmc.main(["MiniWorld-Hallway-v0", "--headless", "--steps", "4", "--obs-width", "16",
              "--obs-height", "12", "--device", "cpu"])
    assert "ran 4 steps on cpu" in capsys.readouterr().out
    for name, check in (("Hallway", lambda a: isinstance(a, int) and 0 <= a < 6),
                        ("CameraControlClick", lambda a: a.shape == (2,) and (0 <= a).all()
                         and (a <= 1).all()),
                        ("PutNext", lambda a: a.shape == (6,) and (a[4:] >= 0).all())):
        env = gym_env.SingleEnv(name, obs_width=16, obs_height=12, device="cpu")
        policy = tmc.random_policy(env, seed=1)
        acts = [policy(None) for _ in range(20)]
        assert all(check(np.asarray(a) if not isinstance(a, int) else a) for a in acts), name
