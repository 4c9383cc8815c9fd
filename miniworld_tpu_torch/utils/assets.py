"""Asset discovery for bundled textures and meshes.

The PNG/OBJ assets are bundled data (see assets/PROVENANCE.md); this
module resolves texture *names* to variant file lists using the same
naming scheme the reference engine uses (``{name}_{1..9}.png``,
reference: miniworld/opengl.py:113-145), so that texture-variant domain
randomization behaves identically.
"""

from __future__ import annotations

import functools
import os

# The asset tree ships once, inside the JAX package's directory; the port
# resolves it as a plain path beside its own package and never imports
# ``miniworld_tpu`` (whose __init__ pulls in jax).
_ASSETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "miniworld_tpu", "assets",
)


def assets_dir() -> str:
    return _ASSETS_DIR


@functools.lru_cache(maxsize=None)
def texture_variant_paths(tex_name: str) -> tuple:
    """All variant files for a texture name, in variant order.

    ``tex_name`` may include a subdirectory (e.g. ``chars/ch_0x66``).
    Variant files are ``{name}_1.png .. {name}_9.png``, stopping at the
    first missing index — identical discovery to the reference.
    """
    paths = []
    for i in range(1, 10):
        path = os.path.join(_ASSETS_DIR, "textures", f"{tex_name}_{i}.png")
        if not os.path.exists(path):
            break
        paths.append(path)
    if not paths:
        # A few assets exist without the _N suffix; accept the bare name.
        bare = os.path.join(_ASSETS_DIR, "textures", f"{tex_name}.png")
        if os.path.exists(bare):
            paths.append(bare)
    if not paths:
        raise FileNotFoundError(f"no texture files found for name {tex_name!r}")
    return tuple(paths)


def mesh_path(mesh_name: str) -> str:
    path = os.path.join(_ASSETS_DIR, "meshes", f"{mesh_name}.obj")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no mesh file found for name {mesh_name!r}")
    return path
