"""LeRobot v3 dataset writer (reference: miniworld/lerobot_writer.py).

Emits the same on-disk layout as the reference recorder so downstream
LeRobot tooling is interchangeable:

    data/chunk-XXX/file-XXX.parquet     transition table
    videos/observation.image/chunk-XXX/file-XXX.mp4   H.264 frames
    meta/info.json                      dataset card + feature schema
    meta/stats.json                     streaming per-feature stats
    meta/tasks.parquet                  task -> task_index
    meta/episodes/chunk-000/episodes-000.parquet      episode index

Design differences from the reference (this is not a port): the writer
is batch-first — ``add_batch`` ingests whole (T, B, ...) rollout arrays
from the vectorized env and splits them into episodes on the done
mask, while ``EpisodeWriter`` keeps the reference's one-episode
interactive flow. Append/resume mode reloads info/tasks/episodes and
continues indices like the reference (lerobot_writer.py:312-407).

The PyTorch port's copy of ``miniworld_tpu/io/lerobot.py`` (host numpy:
it writes the same files; pyarrow, pandas and imageio import lazily).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

DEFAULT_FPS = 30
VIDEO_KEY = "observation.image"
DATA_TEMPLATE = "data/chunk-{chunk_index:03d}/file-{file_index:03d}.parquet"
VIDEO_TEMPLATE = (
    "videos/{video_key}/chunk-{chunk_index:03d}/file-{file_index:03d}.mp4"
)


def build_state_vector(info: Optional[dict]) -> Optional[np.ndarray]:
    """Flatten an env info dict into [pos_xyz, yaw, pitch, extras...].

    Same contract as the reference build_state_vector
    (lerobot_writer.py:52-91): extras (all keys except "agent") are
    appended sorted by key and flattened in C-order.
    """
    if info is None:
        return None
    agent = info.get("agent")
    if agent is None:
        return None
    pos = np.asarray(agent.get("pos"), dtype=np.float32).reshape(-1)
    if pos.size < 3:
        return None
    yaw = float(np.asarray(agent.get("dir"), np.float32).reshape(-1)[0])
    pitch = float(np.asarray(agent.get("cam_pitch"), np.float32).reshape(-1)[0])
    parts = [float(pos[0]), float(pos[1]), float(pos[2]), yaw, pitch]
    for key in sorted(k for k in info if k != "agent"):
        parts.extend(np.asarray(info[key], np.float32).ravel().tolist())
    return np.asarray(parts, dtype=np.float32)


class RunningStats:
    """Streaming mean/std/min/max (lerobot_writer.py:94-160 analog)."""

    def __init__(self):
        self.count = 0
        self.mean = None
        self.m2 = None
        self.min = None
        self.max = None

    def update(self, values: np.ndarray):
        values = np.asarray(values, dtype=np.float64)
        flat = values.reshape(-1, values.shape[-1]) if values.ndim > 1 else values.reshape(-1, 1)
        for row in flat:
            self.count += 1
            if self.mean is None:
                self.mean = row.copy()
                self.m2 = np.zeros_like(row)
                self.min = row.copy()
                self.max = row.copy()
            else:
                delta = row - self.mean
                self.mean += delta / self.count
                self.m2 += delta * (row - self.mean)
                self.min = np.minimum(self.min, row)
                self.max = np.maximum(self.max, row)

    def as_dict(self) -> dict:
        if self.count == 0:
            return {}
        var = self.m2 / max(self.count - 1, 1)
        return {
            "mean": self.mean.tolist(),
            "std": np.sqrt(var).tolist(),
            "min": self.min.tolist(),
            "max": self.max.tolist(),
            "count": self.count,
        }


@dataclass
class Episode:
    """One buffered episode before it is flushed to disk."""

    frames: List[np.ndarray] = field(default_factory=list)
    actions: List[np.ndarray] = field(default_factory=list)
    states: List[Optional[np.ndarray]] = field(default_factory=list)
    rewards: List[float] = field(default_factory=list)
    dones: List[bool] = field(default_factory=list)
    successes: List[bool] = field(default_factory=list)
    task: str = "miniworld"

    def add(self, frame, action, state=None, reward=0.0, done=False,
            success=False):
        self.frames.append(np.asarray(frame, dtype=np.uint8))
        self.actions.append(np.asarray(action, dtype=np.float32).reshape(-1))
        self.states.append(
            None if state is None else np.asarray(state, np.float32).reshape(-1)
        )
        self.rewards.append(float(reward))
        self.dones.append(bool(done))
        self.successes.append(bool(success))

    def __len__(self):
        return len(self.frames)


class DatasetManager:
    """Chunked LeRobot v3 dataset emitter with append/resume."""

    def __init__(self, root, fps: int = DEFAULT_FPS, append: bool = False,
                 default_task: str = "miniworld"):
        self.root = Path(root)
        self.fps = fps
        self.default_task = default_task
        self.meta_dir = self.root / "meta"
        self.episodes_dir = self.meta_dir / "episodes"

        self._tasks: Dict[str, int] = {}
        self._episode_rows: List[dict] = []
        self._num_samples = 0
        self._file_index = 0
        self._stats: Dict[str, RunningStats] = {}
        self._frame_shape = None
        self._action_dim = None
        self._state_dim = None
        self._data_files: List[Path] = []
        self._video_files: List[Path] = []

        if append and (self.meta_dir / "info.json").exists():
            self._load_existing()

    # -- resume ---------------------------------------------------------

    def _load_existing(self):
        """Reload indices so new episodes continue the dataset
        (lerobot_writer.py:312-407 behavior)."""
        import pyarrow.parquet as pq

        info = json.loads((self.meta_dir / "info.json").read_text())
        self._num_samples = int(info.get("total_frames", 0))
        feats = info.get("features", {})
        shape = feats.get(VIDEO_KEY, {}).get("shape")
        if shape:
            self._frame_shape = tuple(shape)
        a_shape = feats.get("action", {}).get("shape")
        if a_shape:
            self._action_dim = int(a_shape[0])
        s_shape = feats.get("observation.state", {}).get("shape")
        if s_shape:
            self._state_dim = int(s_shape[0])

        tasks_path = self.meta_dir / "tasks.parquet"
        if tasks_path.exists():
            table = pq.read_table(tasks_path)
            names = table.column_names
            idxs = table.column("task_index").to_pylist()
            # task strings are the pandas index column
            key = "__index_level_0__" if "__index_level_0__" in names else names[0]
            tasks = table.column(key).to_pylist()
            for t, i in zip(tasks, idxs):
                self._tasks[str(t)] = int(i)

        epi_path = self.episodes_dir / "chunk-000" / "episodes-000.parquet"
        if epi_path.exists():
            table = pq.read_table(epi_path).to_pylist()
            for row in table:
                self._episode_rows.append({
                    "episode_index": int(row["episode_index"]),
                    "chunk_index": int(row.get("data/chunk_index", 0)),
                    "file_index": int(row.get("data/file_index", 0)),
                    "from": int(row["dataset_from_index"]),
                    "to": int(row["dataset_to_index"]),
                    "tasks": list(row.get("tasks") or [self.default_task]),
                })
        existing = sorted(self.root.glob("data/chunk-*/file-*.parquet"))
        self._data_files = list(existing)
        self._video_files = sorted(
            self.root.glob(f"videos/{VIDEO_KEY}/chunk-*/file-*.mp4")
        )
        if existing:
            last = existing[-1].stem  # file-XXX
            self._file_index = int(last.split("-")[1]) + 1

    # -- episode ingestion ------------------------------------------------

    @property
    def num_episodes(self) -> int:
        return len(self._episode_rows)

    def add_episode(self, episode: Episode):
        """Write one episode as its own data/video file pair."""
        if len(episode) == 0:
            return
        idx = self._file_index
        self._file_index += 1
        # The reference writer advances chunk_index and file_index in
        # lockstep — every episode file lives in its own chunk dir
        # (lerobot_writer.py:534-535, 558-560) — so a LeRobot reader
        # resolving the episodes table's template paths finds the files.
        chunk = idx
        data_path = self.root / DATA_TEMPLATE.format(
            chunk_index=chunk, file_index=idx
        )
        video_path = self.root / VIDEO_TEMPLATE.format(
            video_key=VIDEO_KEY, chunk_index=chunk, file_index=idx
        )
        self._write_video(video_path, episode.frames)
        task_idx = self._register_task(episode.task)

        start = self._num_samples
        rows = []
        for t in range(len(episode)):
            rows.append({
                "index": start + t,
                "episode_index": self.num_episodes,
                "frame_index": t,
                "timestamp": t / float(self.fps),
                "task_index": task_idx,
                "action": episode.actions[t],
                "state": episode.states[t],
                "next.reward": episode.rewards[t],
                "next.done": episode.dones[t],
                "next.success": episode.successes[t],
            })
        self._write_parquet(data_path, rows)
        self._num_samples += len(episode)

        self._frame_shape = tuple(episode.frames[0].shape)
        self._action_dim = int(episode.actions[0].size)
        if episode.states[0] is not None:
            self._state_dim = int(episode.states[0].size)

        self._update_stats(episode)
        self._episode_rows.append({
            "episode_index": self.num_episodes,
            "chunk_index": chunk,
            "file_index": idx,
            "from": start,
            "to": start + len(episode),
            "tasks": [episode.task],
        })

    def add_batch(self, frames, actions, rewards, dones, states=None,
                  successes=None, task: str | None = None):
        """Vectorized ingestion: (T, B, H, W, 3) frames et al.; episode
        boundaries cut on the done mask per env column."""
        frames = np.asarray(frames)
        actions = np.asarray(actions)
        rewards = np.asarray(rewards)
        dones = np.asarray(dones)
        T, B = frames.shape[0], frames.shape[1]
        for b in range(B):
            ep = Episode(task=task or self.default_task)
            for t in range(T):
                st = None if states is None else np.asarray(states[t][b])
                suc = False if successes is None else bool(successes[t][b])
                act = actions[t][b]
                if np.ndim(act) == 0:
                    act = np.array([act], np.float32)
                ep.add(frames[t, b], act, st, float(rewards[t, b]),
                       bool(dones[t, b]), suc)
                if dones[t, b]:
                    self.add_episode(ep)
                    ep = Episode(task=task or self.default_task)
            if len(ep):
                self.add_episode(ep)

    # -- finalize ----------------------------------------------------------

    def finalize(self):
        self._write_tasks()
        self._write_episodes()
        self._write_stats()
        self._write_info()

    # -- internals ----------------------------------------------------------

    def _register_task(self, task: str) -> int:
        if task not in self._tasks:
            self._tasks[task] = len(self._tasks)
        return self._tasks[task]

    def _update_stats(self, ep: Episode):
        def get(name):
            if name not in self._stats:
                self._stats[name] = RunningStats()
            return self._stats[name]

        get("action").update(np.stack(ep.actions))
        if ep.states[0] is not None:
            get("observation.state").update(np.stack(ep.states))
        get("next.reward").update(np.asarray(ep.rewards, np.float64)[:, None])

    def _write_video(self, path: Path, frames):
        path.parent.mkdir(parents=True, exist_ok=True)
        try:
            import imageio.v2 as imageio

            writer = imageio.get_writer(
                str(path), fps=self.fps, codec="h264", format="FFMPEG",
                pixelformat="yuv420p", macro_block_size=1,
            )
            for f in frames:
                writer.append_data(f)
            writer.close()
        except Exception:
            # no ffmpeg available: store a lossless npz fallback so the
            # dataset remains complete (path recorded with .npz suffix)
            np.savez_compressed(path.with_suffix(".npz"),
                                frames=np.stack(frames))
            path = path.with_suffix(".npz")
        self._video_files.append(path)

    def _write_parquet(self, path: Path, rows):
        import pyarrow as pa
        import pyarrow.parquet as pq

        path.parent.mkdir(parents=True, exist_ok=True)
        table = pa.Table.from_arrays(
            [
                pa.array([r["index"] for r in rows], type=pa.int64()),
                pa.array([r["episode_index"] for r in rows], type=pa.int64()),
                pa.array([r["frame_index"] for r in rows], type=pa.int64()),
                pa.array([r["timestamp"] for r in rows], type=pa.float32()),
                pa.array([r["task_index"] for r in rows], type=pa.int64()),
                pa.array(
                    [np.asarray(r["action"]).tolist() for r in rows],
                    type=pa.list_(pa.float32()),
                ),
                pa.array(
                    [None if r["state"] is None else np.asarray(r["state"]).tolist()
                     for r in rows],
                    type=pa.list_(pa.float32()),
                ),
                pa.array([r["next.reward"] for r in rows], type=pa.float32()),
                pa.array([r["next.done"] for r in rows], type=pa.bool_()),
                pa.array([r["next.success"] for r in rows], type=pa.bool_()),
            ],
            names=[
                "index", "episode_index", "frame_index", "timestamp",
                "task_index", "action", "observation.state", "next.reward",
                "next.done", "next.success",
            ],
        )
        pq.write_table(table, path)
        self._data_files.append(path)

    def _write_tasks(self):
        import pandas as pd

        self.meta_dir.mkdir(parents=True, exist_ok=True)
        if not self._tasks:
            self._register_task(self.default_task)
        items = sorted(self._tasks.items(), key=lambda kv: kv[1])
        df = pd.DataFrame(
            {"task_index": [i for _, i in items]}, index=[t for t, _ in items]
        )
        df.to_parquet(self.meta_dir / "tasks.parquet", index=True)

    def _write_stats(self):
        stats = {k: v.as_dict() for k, v in self._stats.items()}
        (self.meta_dir / "stats.json").write_text(json.dumps(stats, indent=2))

    def _write_episodes(self):
        import pyarrow as pa
        import pyarrow.parquet as pq

        out_dir = self.episodes_dir / "chunk-000"
        out_dir.mkdir(parents=True, exist_ok=True)
        rows = self._episode_rows
        table = pa.Table.from_arrays(
            [
                pa.array([r["episode_index"] for r in rows], type=pa.int64()),
                pa.array([r["chunk_index"] for r in rows], type=pa.int64()),
                pa.array([r["file_index"] for r in rows], type=pa.int64()),
                pa.array([r["from"] for r in rows], type=pa.int64()),
                pa.array([r["to"] for r in rows], type=pa.int64()),
                pa.array([r["chunk_index"] for r in rows], type=pa.int64()),
                pa.array([r["file_index"] for r in rows], type=pa.int64()),
                pa.array(
                    [r["from"] / float(self.fps) for r in rows], type=pa.float32()
                ),
                pa.array(
                    [r["to"] / float(self.fps) for r in rows], type=pa.float32()
                ),
                pa.array([r["tasks"] for r in rows], type=pa.list_(pa.string())),
                pa.array([r["to"] - r["from"] for r in rows], type=pa.int64()),
            ],
            names=[
                "episode_index", "data/chunk_index", "data/file_index",
                "dataset_from_index", "dataset_to_index",
                f"videos/{VIDEO_KEY}/chunk_index",
                f"videos/{VIDEO_KEY}/file_index",
                f"videos/{VIDEO_KEY}/from_timestamp",
                f"videos/{VIDEO_KEY}/to_timestamp",
                "tasks", "length",
            ],
        )
        pq.write_table(table, out_dir / "episodes-000.parquet")

    def _write_info(self):
        def size_mb(files):
            total = sum(p.stat().st_size for p in files if p.exists())
            return total / 1_000_000 if total else 0.0

        info = {
            "codebase_version": "v3.0",
            "robot_type": "unknown",
            "total_episodes": self.num_episodes,
            "total_frames": self._num_samples,
            "total_tasks": max(len(self._tasks), 1),
            "chunks_size": 1000,
            "fps": self.fps,
            "splits": {"train": f"0:{self.num_episodes}"},
            "data_path": DATA_TEMPLATE,
            "video_path": VIDEO_TEMPLATE,
            "features": self._feature_schema(),
            "data_files_size_in_mb": size_mb(self._data_files),
            "video_files_size_in_mb": size_mb(self._video_files),
        }
        self.meta_dir.mkdir(parents=True, exist_ok=True)
        (self.meta_dir / "info.json").write_text(json.dumps(info, indent=2))

    def _feature_schema(self):
        fps = float(self.fps)
        scalar = lambda dt: {"dtype": dt, "shape": [1], "names": None, "fps": fps}
        return {
            VIDEO_KEY: {
                "dtype": "video",
                "shape": list(self._frame_shape) if self._frame_shape else [],
                "names": ["height", "width", "channel"],
                "video_info": {
                    "video.fps": fps, "video.codec": "h264",
                    "video.pix_fmt": "yuv420p", "video.is_depth_map": False,
                    "has_audio": False,
                },
            },
            "observation.state": {
                "dtype": "float32",
                "shape": [self._state_dim] if self._state_dim else [],
                "names": None, "fps": fps,
            },
            "action": {
                "dtype": "float32",
                "shape": [self._action_dim] if self._action_dim else [],
                "names": None, "fps": fps,
            },
            "episode_index": scalar("int64"),
            "frame_index": scalar("int64"),
            "timestamp": scalar("float32"),
            "next.reward": scalar("float32"),
            "next.done": scalar("bool"),
            "next.success": scalar("bool"),
            "index": scalar("int64"),
            "task_index": scalar("int64"),
        }


# interactive single-episode flow (reference EpisodeWriter parity)
class EpisodeWriter:
    """Buffer one episode; flush into a DatasetManager on close."""

    def __init__(self, manager: DatasetManager, task: str | None = None):
        self.manager = manager
        self.episode = Episode(task=task or manager.default_task)

    @property
    def num_frames(self):
        return len(self.episode)

    def add_sample(self, frame, action, state=None, reward=0.0, done=False,
                   success=False):
        self.episode.add(frame, action, state, reward, done, success)

    def close(self):
        self.manager.add_episode(self.episode)
        return self.manager.root

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
