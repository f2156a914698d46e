"""Gaussian map <-> PLY (port of fourdgs/io/ply.py): x y z nx ny nz
f_dc_0..2 opacity scale_0..2 rot_0..3 dygs, binary little-endian float32,
alive slots only. The byte layout is the reference's, so the two packages
read each other's files."""

from __future__ import annotations

import numpy as np

_PROPS = (
    ["x", "y", "z", "nx", "ny", "nz"]
    + [f"f_dc_{i}" for i in range(3)]
    + ["opacity"]
    + [f"scale_{i}" for i in range(3)]
    + [f"rot_{i}" for i in range(4)]
    + ["dygs"]
)


def save_gaussians_ply(gmap, path: str) -> int:
    """Write the alive Gaussians of `gmap`; returns their number."""
    alive = gmap.alive.cpu().numpy()
    p = gmap.params

    def host(t):
        return t.detach().cpu().numpy()[alive]

    xyz, f_dc, scaling, rotation = host(p.xyz), host(p.f_dc), host(p.scaling), host(p.rotation)
    n = xyz.shape[0]
    data = np.zeros(n, dtype=[(name, "<f4") for name in _PROPS])
    data["x"], data["y"], data["z"] = xyz.T
    for i in range(3):
        data[f"f_dc_{i}"] = f_dc[:, i]
        data[f"scale_{i}"] = scaling[:, i]
    data["opacity"] = host(p.opacity)[:, 0]
    for i in range(4):
        data[f"rot_{i}"] = rotation[:, i]
    data["dygs"] = gmap.dygs.cpu().numpy()[alive].astype(np.float32)

    header = ("ply\nformat binary_little_endian 1.0\n" f"element vertex {n}\n"
              + "".join(f"property float {name}\n" for name in _PROPS) + "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())
    return n


def load_gaussians_ply(path: str) -> dict:
    """Numpy arrays (xyz, f_dc, opacity, scaling, rotation, dygs) of a PLY
    this format writes; files without a dygs channel (the reference's
    upstream export) load as all static."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        n, props = 0, []
        for ln in header.decode("ascii").splitlines():
            if ln.startswith("element vertex"):
                n = int(ln.split()[-1])
            elif ln.startswith("property float"):
                props.append(ln.split()[-1])
        dtype = np.dtype([(name, "<f4") for name in props])
        data = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype)

    def col(name, default=0.0):
        return np.asarray(data[name]) if name in props else np.full(n, default, np.float32)

    return {
        "xyz": np.stack([col("x"), col("y"), col("z")], -1),
        "f_dc": np.stack([col(f"f_dc_{i}") for i in range(3)], -1),
        "opacity": col("opacity")[:, None],
        "scaling": np.stack([col(f"scale_{i}") for i in range(3)], -1),
        "rotation": np.stack([col(f"rot_{i}", 1.0 if i == 0 else 0.0) for i in range(4)], -1),
        "dygs": col("dygs") > 0.5,
    }
