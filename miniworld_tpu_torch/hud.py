"""Clickable HUD control overlays (reference: miniworld.py:1320-1574).

The reference draws button panels (move/strafe/look) either onto the
rgb_array observation via cv2 or as pyglet window shapes, and exposes
``control_boxes`` — a name -> pixel-rect dict the interaction layer
hit-tests clicks against. Envs can override the button set via
``control_action_map`` (CameraControl's pan/tilt/zoom panel,
cameracontrol.py:125-132).

This module draws the same panels with pure numpy (no cv2 dependency)
and provides the hit-test dict; manual_control.py consumes both.

The PyTorch port's copy of ``miniworld_tpu/hud.py`` (host numpy; the
port imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

# (label, action) — action is (component_index, value) into the 6-D
# action vector, matching the reference's default move/strafe/look set
DEFAULT_CONTROLS = [
    ("fwd", (0, 1.0)), ("back", (0, -1.0)),
    ("s.left", (1, -1.0)), ("s.right", (1, 1.0)),
    ("t.left", (2, -1.0)), ("t.right", (2, 1.0)),
    ("p.up", (3, 1.0)), ("p.down", (3, -1.0)),
    ("pick", (4, 1.0)), ("drop", (5, 1.0)),
]

def control_layout(width: int, height: int, labels) -> dict:
    """name -> (x0, y0, x1, y1) pixel boxes along the bottom edge."""
    n = len(labels)
    pad = max(2, width // 100)
    bw = (width - pad * (n + 1)) // max(n, 1)
    bh = max(10, height // 10)
    y1 = height - pad
    y0 = y1 - bh
    boxes = {}
    x = pad
    for name in labels:
        boxes[name] = (x, y0, x + bw, y1)
        x += bw + pad
    return boxes


def draw_controls(frame: np.ndarray, boxes: dict, hover: str | None = None,
                  pressed: str | None = None) -> np.ndarray:
    """Blend semi-transparent button rectangles into an RGB frame."""
    out = frame.copy()
    for name, (x0, y0, x1, y1) in boxes.items():
        if name == pressed:
            color, alpha = np.array([255, 200, 60]), 0.75
        elif name == hover:
            color, alpha = np.array([200, 200, 255]), 0.6
        else:
            color, alpha = np.array([60, 60, 80]), 0.45
        region = out[y0:y1, x0:x1].astype(np.float32)
        out[y0:y1, x0:x1] = (
            (1 - alpha) * region + alpha * color[None, None, :]
        ).astype(np.uint8)
        # 1px border
        out[y0, x0:x1] = 230
        out[y1 - 1, x0:x1] = 230
        out[y0:y1, x0] = 230
        out[y0:y1, x1 - 1] = 230
    return out


def hit_test(boxes: dict, x: int, y: int) -> str | None:
    """First control box containing the pixel (miniworld.py:1389-1391)."""
    for name, (x0, y0, x1, y1) in boxes.items():
        if x0 <= x <= x1 and y0 <= y <= y1:
            return name
    return None


# 3x5 bitmap glyphs for the pose readout (reference draws pose text on
# the human view, miniworld.py:1744-1770); tiny but dependency-free
_FONT = {
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001001001001", "8": "111101111101111",
    "9": "111101111001111", ".": "000000000000010", "-": "000000111000000",
    " ": "000000000000000", "x": "000101010101000", "y": "000101010010010",
    "z": "000111010100111", "d": "001001011101111", "p": "110101110100100",
    ":": "000010000010000", "=": "000111000111000",
}


def draw_text(frame: np.ndarray, text: str, x: int, y: int,
              scale: int = 1, color=(255, 255, 0),
              max_x: int | None = None) -> np.ndarray:
    """Blit a tiny bitmap string into an RGB frame (in place)."""
    col = np.array(color, dtype=np.uint8)
    limit = frame.shape[1] if max_x is None else min(max_x, frame.shape[1])
    for ch in text:
        if x >= limit - 4 * scale:
            break
        glyph = _FONT.get(ch)
        if glyph is not None:
            for gy in range(5):
                for gx in range(3):
                    if glyph[gy * 3 + gx] == "1":
                        y0, x0 = y + gy * scale, x + gx * scale
                        frame[y0:y0 + scale, x0:x0 + scale] = col
        x += 4 * scale
    return frame


def compose_human_frame(obs: np.ndarray, top_view: np.ndarray | None,
                        pose=None) -> np.ndarray:
    """Reference-style human render: first-person view with a top-view
    picture-in-picture and the agent pose readout
    (miniworld.py:1678-1790)."""
    frame = obs.copy()
    text_max_x = None
    h, w = frame.shape[:2]
    if top_view is not None and h >= 24 and w >= 24:
        th = min(max(16, h // 3), h - 4)
        tw = min(max(16, w // 3), w - 4)
        from PIL import Image

        thumb = np.asarray(
            Image.fromarray(top_view).resize((tw, th), Image.BILINEAR)
        )
        frame[2:2 + th, w - tw - 2:w - 2] = thumb
        frame[1, w - tw - 3:w - 1] = 255
        frame[2 + th, w - tw - 3:w - 1] = 255
        frame[1:3 + th, w - tw - 3] = 255
        frame[1:3 + th, w - 2] = 255
        text_max_x = w - tw - 4
    if pose is not None:
        px, pz, pdir = pose
        draw_text(frame, f"x={px:.1f} z={pz:.1f} d={pdir:.1f}", 2, 2,
                  max_x=text_max_x)
    return frame
