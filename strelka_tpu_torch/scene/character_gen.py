"""Einar-class character stage generator (numpy only): a textured bust and a
groom of cubic B-spline strands in one binary .usdc stage.

The reference's second showcase renders Einar, a character with curve hair
(Strelka README.md:6: 1024 spp, depth 3). The asset is not public and no
source states its sizes, so this is a stand-in at the repository's own
estimate of its hair (10^6 curve segments, NOTES.md:564):

  * the bust: a head about 0.24 m tall, a neck and shoulders, one surface of
    revolution with a nose, brows, ears and a chin, in two meshes with
    per-vertex normals and UVs: skin (OmniPBR with a generated 1024x1024
    diffuse texture) and tunic (OmniPBR, untextured); a 2-triangle backdrop;
  * the groom: cubic BasisCurves strands of 8 control points (5 segments,
    40 round cones each), rooted on the scalp and jaw triangles (chosen by
    area), grown along the surface normal and bent by gravity with seeded
    jitter, widths (USD diameters) tapering from 1.2e-4 m to 4e-5 m, in
    OmniHair (the Chiang fibre BSDF);
  * a 0.6 x 0.6 m rect key light in front and to the left, a distant rim
    light from behind (3 degree half-angle), and a camera (fov 30 degrees) in
    a three-quarter view at head height.

At the full size (`FULL`) the bust has 249,856 triangles and the groom
200,000 strands: 1,000,000 segments, 8,000,000 cones. Everything is seeded
and deterministic; scene/character.py:ensure_character generates the stage
into data/gen/character/. The stage goes through loaders/crate.py:write_usdc
and the texture through utils/image.py:write_png(as_pil=True).
"""

from __future__ import annotations

import os

import numpy as np

from strelka_tpu_torch.loaders.usda_parser import Attr, Prim

# full size: the bust's grid (around, down), scalp and beard strands, the texture's edge
FULL = dict(around=512, down=244, scalp=160_000, beard=40_000, texture=1024)
CTRL = 8  # control points a strand
ROOT_WIDTH, TIP_WIDTH = 1.2e-4, 4e-5  # USD widths (diameters), metres
NECKLINE = -0.095  # rows below this height are the tunic
# the bust's profile from the crown down: height y, half-width, half-depth, forward offset (metres)
PROFILE = np.array([
    [0.240, 0.004, 0.004, -0.005],
    [0.232, 0.040, 0.046, -0.008],
    [0.215, 0.062, 0.074, -0.008],
    [0.185, 0.076, 0.093, -0.006],
    [0.140, 0.081, 0.101, -0.002],
    [0.095, 0.079, 0.098, 0.002],
    [0.055, 0.073, 0.090, 0.004],
    [0.025, 0.063, 0.080, 0.008],
    [0.000, 0.048, 0.064, 0.012],
    [-0.018, 0.047, 0.050, 0.000],
    [-0.050, 0.054, 0.054, -0.012],
    [-0.085, 0.062, 0.060, -0.014],
    [-0.110, 0.120, 0.080, -0.012],
    [-0.135, 0.180, 0.100, -0.010],
    [-0.170, 0.215, 0.115, -0.008],
    [-0.230, 0.225, 0.120, -0.006],
    [-0.340, 0.225, 0.120, -0.006],
], np.float64)


def _bump(phi, y, phi0, y0, sphi, sy):
    return np.exp(-((phi - phi0) / sphi) ** 2 - ((y - y0) / sy) ** 2)


def bust_grid(around: int, down: int) -> tuple:
    """The bust's vertex grid: positions [down + 1, around + 1, 3] f64 (the
    seam's column repeated for the UVs) and each row's height (before the
    features), rows spaced evenly along the profile's length."""
    seg = np.linalg.norm(np.diff(PROFILE[:, [0, 2]], axis=0), axis=1)
    arc = np.concatenate([[0.0], np.cumsum(seg)])
    s = np.linspace(0.0, arc[-1], down + 1)
    y, rx, rz, cz = (np.interp(s, arc, PROFILE[:, k]) for k in range(4))
    phi = np.linspace(-np.pi, np.pi, around + 1)  # 0 faces +z (the face)
    Y, PHI = np.meshgrid(y, phi, indexing="ij")
    head = np.clip((Y + 0.02) / 0.04, 0.0, 1.0)  # the features lie on the head only
    radial = 1.0 + head * (0.10 * _bump(np.abs(PHI), Y, np.pi / 2, 0.100, 0.16, 0.030)  # ears
                           - 0.06 * _bump(np.abs(PHI), Y, 0.55, 0.115, 0.25, 0.025))  # eye sockets
    fwd = head * (0.022 * _bump(PHI, Y, 0.0, 0.085, 0.16, 0.024)  # nose
                  + 0.008 * _bump(PHI, Y, 0.0, 0.130, 0.55, 0.012)  # brow
                  + 0.010 * _bump(PHI, Y, 0.0, 0.010, 0.35, 0.020))  # chin
    x = rx[:, None] * radial * np.sin(PHI)
    z = cz[:, None] + (rz[:, None] * radial + fwd) * np.cos(PHI)
    return np.stack([x, Y, z], axis=-1), y


def _quads(rows: int, around: int, first_row: int) -> np.ndarray:
    """[rows * around, 4] vertex indices of a band of the grid's quads,
    wound outward (the loader fans each quad into two triangles)."""
    w = around + 1
    j, i = np.meshgrid(np.arange(first_row, first_row + rows), np.arange(around), indexing="ij")
    a = (j * w + i).reshape(-1)
    return np.stack([a, a + w, a + w + 1, a + 1], axis=1)


def vertex_normals(pos: np.ndarray, quads: np.ndarray, around: int) -> np.ndarray:
    """Area-weighted per-vertex normals [V, 3] of the fanned quads, the seam's
    two columns summed as one vertex."""
    w = around + 1
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    fn = np.cross(pos[tris[:, 1]] - pos[tris[:, 0]], pos[tris[:, 2]] - pos[tris[:, 0]])
    welded = np.where(tris % w == around, tris - around, tris)  # the seam column onto the first
    acc = np.zeros_like(pos)
    for k in range(3):
        np.add.at(acc, welded[:, k], fn)
    seam = np.arange(around, pos.shape[0], w)
    acc[seam] = acc[seam - around]
    return acc / np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), 1e-12)


def skin_texture(n: int, rng: np.random.Generator) -> np.ndarray:
    """[n, n, 3] f32 in 0..1: a skin tone with blotches, a cheek flush and pores."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / np.float32(n)
    blotch = np.zeros((n, n), np.float32)
    for fx, fy, ph in rng.uniform((2.0, 2.0, 0.0), (9.0, 9.0, 2 * np.pi), (6, 3)):
        blotch += np.sin(2 * np.pi * (fx * x + fy * y) + ph).astype(np.float32)
    flush = np.exp(-(((x - 0.5) % 1.0 - 0.5) / 0.08) ** 2 - ((y - 0.24) / 0.05) ** 2).astype(np.float32)
    pores = rng.uniform(-0.035, 0.035, (n, n)).astype(np.float32)
    v = 0.02 * blotch + pores
    base = np.stack([0.78 + v + 0.08 * flush, 0.58 + v, 0.48 + v - 0.03 * flush], axis=-1)
    return np.clip(base, 0.0, 1.0).astype(np.float32)


def _roots(pos, nrm, tris, pick, count, rng):
    """`count` points on the triangles `pick` (by area) and their interpolated normals."""
    p0, p1, p2 = (pos[tris[pick, k]] for k in range(3))
    area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=1)
    which = rng.choice(pick.shape[0], size=count, p=area / area.sum())
    r1, r2 = rng.uniform(0.0, 1.0, (2, count))
    s = np.sqrt(r1)
    b = np.stack([1.0 - s, s * (1.0 - r2), s * r2], axis=1)  # uniform over the triangle
    corners = tris[pick[which]]
    root = sum(b[:, k:k + 1] * pos[corners[:, k]] for k in range(3))
    n = sum(b[:, k:k + 1] * nrm[corners[:, k]] for k in range(3))
    return root, n / np.linalg.norm(n, axis=1, keepdims=True)


def grow_strands(root, normal, lo, hi, gravity, comb, rng) -> np.ndarray:
    """[S, CTRL, 3] control points: each strand `lo`..`hi` long, leaving its
    root along the normal, away from the head's axis, bent by gravity and
    combed back (-z) by `comb`, with jitter."""
    count = root.shape[0]
    length = rng.uniform(lo, hi, count)
    step = (length / (CTRL - 1))[:, None]
    away = np.stack([root[:, 0], np.zeros(count), root[:, 2]], axis=1)
    away /= np.maximum(np.linalg.norm(away, axis=1, keepdims=True), 1e-9)
    jitter = rng.normal(0.0, 0.18, (CTRL - 1, count, 3))
    pts = np.zeros((count, CTRL, 3))
    pts[:, 0] = root + 4e-4 * normal
    d = normal.copy()
    for k in range(1, CTRL):
        d = d + 0.25 * away + jitter[k - 1] + np.array([0.0, -gravity * k / (CTRL - 1), -comb])
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pts[:, k] = pts[:, k - 1] + step * d
    return pts


def _mesh_prim(path, pos, nrm, uv, quads, material):
    used = np.unique(quads)
    remap = np.full(pos.shape[0], -1, np.int64)
    remap[used] = np.arange(used.shape[0])
    p = Prim(type="Mesh", name=path.rsplit("/", 1)[-1], path=path)
    p.attrs["points"] = Attr("point3f[]", pos[used].astype(np.float32))
    p.attrs["faceVertexIndices"] = Attr("int[]", remap[quads].reshape(-1))
    p.attrs["faceVertexCounts"] = Attr("int[]", np.full(quads.shape[0], 4, np.int64))
    p.attrs["normals"] = Attr("normal3f[]", nrm[used].astype(np.float32))
    p.attrs["primvars:st"] = Attr("texCoord2f[]", uv[used].astype(np.float32))
    p.attrs["primvars:st:__interp__"] = Attr("token", "vertex")
    p.attrs["material:binding"] = Attr("rel", targets=[material])
    return p


def _curves_prim(path, pts, material):
    p = Prim(type="BasisCurves", name=path.rsplit("/", 1)[-1], path=path)
    p.attrs["type"] = Attr("token", "cubic", uniform=True)
    p.attrs["basis"] = Attr("token", "bspline", uniform=True)
    p.attrs["curveVertexCounts"] = Attr("int[]", np.full(pts.shape[0], CTRL, np.int64))
    p.attrs["points"] = Attr("point3f[]", pts.reshape(-1, 3).astype(np.float32))
    widths = np.tile(np.linspace(ROOT_WIDTH, TIP_WIDTH, CTRL), pts.shape[0]).astype(np.float32)
    p.attrs["widths"] = Attr("float[]", widths)
    p.attrs["widths:__interp__"] = Attr("token", "vertex")
    p.attrs["material:binding"] = Attr("rel", targets=[material])
    return p


def _mdl_material(looks, name, module, inputs):
    """A one-shader MDL network (info:mdl:sourceAsset), as the loader reads it."""
    mat = Prim(type="Material", name=name, path=f"{looks}/{name}")
    sh = Prim(type="Shader", name="S", path=f"{looks}/{name}/S")
    sh.attrs["info:implementationSource"] = Attr("token", "sourceAsset", uniform=True)
    sh.attrs["info:mdl:sourceAsset"] = Attr("asset", ("__asset__", module + ".mdl"), uniform=True)
    sh.attrs["info:mdl:sourceAsset:subIdentifier"] = Attr("token", module, uniform=True)
    for key, (type_str, value) in inputs.items():
        sh.attrs["inputs:" + key] = Attr(type_str, value)
    sh.attrs["outputs:out"] = Attr("token")
    mat.attrs["outputs:mdl:surface"] = Attr("token", connect=f"{looks}/{name}/S.outputs:out")
    mat.children.append(sh)
    return mat


def _xformed(ptype, name, attrs, translate=None, rotate=None):
    p = Prim(type=ptype, name=name, path=f"/World/{name}")
    p.attrs.update(attrs)
    order = []
    if translate is not None:
        p.attrs["xformOp:translate"] = Attr("double3", tuple(float(v) for v in translate))
        order.append("xformOp:translate")
    if rotate is not None:
        p.attrs["xformOp:rotateXYZ"] = Attr("double3", tuple(float(v) for v in rotate))
        order.append("xformOp:rotateXYZ")
    p.attrs["xformOpOrder"] = Attr("token[]", order, uniform=True)
    return p


def build_character_stage(out_dir: str, around: int = FULL["around"], down: int = FULL["down"],
                          scalp: int = FULL["scalp"], beard: int = FULL["beard"], texture: int = FULL["texture"],
                          seed: int = 24) -> str:
    """Generate the stage and its texture under out_dir; returns the .usdc path."""
    from strelka_tpu_torch.loaders.crate import write_usdc
    from strelka_tpu_torch.utils.image import write_png

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "textures"), exist_ok=True)
    write_png(os.path.join(out_dir, "textures", "skin.png"), skin_texture(texture, rng), flip=False, as_pil=True)

    grid, row_y = bust_grid(around, down)
    pos = grid.reshape(-1, 3)
    w = around + 1
    v, u = np.meshgrid(np.linspace(0.0, 1.0, down + 1), np.linspace(0.0, 1.0, around + 1), indexing="ij")
    uv = np.stack([u.reshape(-1), 1.0 - v.reshape(-1)], axis=1)
    split = int(np.argmax(row_y < NECKLINE))  # the first tunic row
    skin_q, tunic_q = _quads(split, around, 0), _quads(down - split, around, split)
    nrm = vertex_normals(pos, np.concatenate([skin_q, tunic_q]), around)

    # roots: the scalp behind a hairline and round the back down to the nape,
    # the beard on the jaw and chin; by each skin triangle's centroid
    tris = np.concatenate([skin_q[:, [0, 1, 2]], skin_q[:, [0, 2, 3]]])
    cen = pos[tris].mean(axis=1)
    phi = np.abs(np.arctan2(cen[:, 0], cen[:, 2]))
    on_scalp = ((cen[:, 1] > 0.150) & ((cen[:, 1] > 0.200) | (phi > 0.9))) | ((cen[:, 1] > 0.060) & (phi > 1.75))
    on_jaw = (cen[:, 1] > -0.012) & (cen[:, 1] < 0.045) & (phi < 1.35)
    s_root, s_n = _roots(pos, nrm, tris, np.nonzero(on_scalp)[0], scalp, rng)
    b_root, b_n = _roots(pos, nrm, tris, np.nonzero(on_jaw)[0], beard, rng)
    s_pts = grow_strands(s_root, s_n, 0.15, 0.35, 1.6, 0.6, rng)
    b_pts = grow_strands(b_root, b_n, 0.05, 0.12, 0.9, 0.0, rng)

    L = "/World/Looks"
    looks = Prim(type="Scope", name="Looks", path=L)
    looks.children = [
        _mdl_material(L, "Skin", "OmniPBR", {
            "diffuse_color_constant": ("color3f", (0.8, 0.62, 0.52)),
            "diffuse_texture": ("asset", ("__asset__", "textures/skin.png")),
            "reflection_roughness_constant": ("float", 0.45),
            "metallic_constant": ("float", 0.0)}),
        _mdl_material(L, "Tunic", "OmniPBR", {
            "diffuse_color_constant": ("color3f", (0.16, 0.22, 0.35)),
            "reflection_roughness_constant": ("float", 0.85),
            "metallic_constant": ("float", 0.0)}),
        _mdl_material(L, "Backdrop", "OmniPBR", {
            "diffuse_color_constant": ("color3f", (0.42, 0.42, 0.45)),
            "reflection_roughness_constant": ("float", 1.0),
            "metallic_constant": ("float", 0.0)}),
        _mdl_material(L, "Hair", "OmniHair", {"reflection_roughness_constant": ("float", 0.3)}),
    ]
    bust = Prim(type="Xform", name="Bust", path="/World/Bust")
    bust.children = [_mesh_prim("/World/Bust/skin", pos, nrm, uv, skin_q, f"{L}/Skin"),
                     _mesh_prim("/World/Bust/tunic", pos, nrm, uv, tunic_q, f"{L}/Tunic")]
    e = np.array([[-2.5, -1.0, -0.6], [1.5, -1.0, -0.6], [1.5, 1.2, -0.6], [-2.5, 1.2, -0.6]])
    backdrop = _mesh_prim("/World/backdrop", e, np.tile([0.0, 0.0, 1.0], (4, 1)),
                          np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]),
                          np.array([[0, 1, 2, 3]]), f"{L}/Backdrop")
    groom = Prim(type="Xform", name="Groom", path="/World/Groom")
    groom.children = [_curves_prim("/World/Groom/scalp", s_pts, f"{L}/Hair"),
                      _curves_prim("/World/Groom/beard", b_pts, f"{L}/Hair")]

    key = _xformed("RectLight", "key", {
        "inputs:color": Attr("color3f", (1.0, 0.96, 0.9)),
        "inputs:intensity": Attr("float", 20000.0),
        "inputs:width": Attr("float", 0.6),
        "inputs:height": Attr("float", 0.6)}, translate=(-0.55, 0.40, 0.95), rotate=(-15.0, -30.0, 0.0))
    rim = _xformed("DistantLight", "rim", {
        "inputs:color": Attr("color3f", (0.85, 0.9, 1.0)),
        "inputs:intensity": Attr("float", 300.0),
        "inputs:angle": Attr("float", 6.0)}, rotate=(20.0, 160.0, 0.0))
    cam = _xformed("Camera", "cam", {
        "focalLength": Attr("float", 50.0),
        "horizontalAperture": Attr("float", 35.7265),
        "verticalAperture": Attr("float", 26.7949)}, translate=(0.62, 0.06, 0.74), rotate=(-5.4, 40.0, 0.0))

    world = Prim(type="Xform", name="World", path="/World")
    world.children = [bust, backdrop, groom, cam, key, rim, looks]
    root = Prim(name="", path="/")
    root.children = [world]
    root.metadata["defaultPrim"] = "World"
    usdc = os.path.join(out_dir, "character.usdc")
    write_usdc(usdc, root)
    return usdc
