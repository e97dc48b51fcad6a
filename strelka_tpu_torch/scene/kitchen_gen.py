"""Kitchen-class benchmark stage generator — the PyTorch port's copy of
strelka_tpu/scene/kitchen_gen.py (numpy only).

Builds a multi-material, multi-textured interior (>=100k tris, 10 materials,
4 generated textures, 4 lights) and writes it as a **binary .usdc stage**
through the crate writer, plus procedural PNG textures — so the bench
exercises the full USD ingestion path (crate reader -> hydra-style sync ->
material network translation -> texture atlas) at Kitchen-Set scale, the
role the reference's hdRunner + pxr Kitchen_set plays
(/root/reference/src/hdRunner/main.cpp:566-591).

Everything is deterministic (seeded); scene/kitchen.py:ensure_kitchen
generates the stage on first use into data/gen/kitchen/. The textures go through
utils/image.py:write_png(as_pil=True) and the stage through
loaders/crate.py:write_usdc, so that with the same zlib the files are
byte-equal to the JAX generator's.
"""

from __future__ import annotations

import os

import numpy as np

from strelka_tpu_torch.loaders.usda_parser import Attr, Prim


# ---------------------------------------------------------------------------
# procedural textures
# ---------------------------------------------------------------------------


def _tex_checker(n=256):
    y, x = np.mgrid[0:n, 0:n]
    c = ((x // 32 + y // 32) % 2).astype(np.float32)
    base = np.stack([0.85 - 0.55 * c, 0.82 - 0.52 * c, 0.76 - 0.48 * c], -1)
    noise = np.random.default_rng(1).uniform(-0.03, 0.03, (n, n, 1)).astype(np.float32)
    return np.clip(base + noise, 0, 1)


def _tex_wood(n=256):
    rng = np.random.default_rng(2)
    y, x = np.mgrid[0:n, 0:n]
    rings = np.sin((x * 0.035 + 8.0 * np.sin(y * 0.01)) * 3.0 + rng.uniform(0, 6)) * 0.5 + 0.5
    grain = rng.uniform(-0.05, 0.05, (n, n)).astype(np.float32)
    v = 0.32 + 0.18 * rings + grain
    return np.clip(np.stack([v * 1.25, v * 0.78, v * 0.45], -1), 0, 1).astype(np.float32)


def _tex_wallpaper(n=256):
    y, x = np.mgrid[0:n, 0:n]
    stripes = (np.sin(x * np.pi / 16.0) * 0.5 + 0.5) ** 2
    v = 0.62 + 0.10 * stripes
    dots = ((x % 64 < 4) & (y % 64 < 4)).astype(np.float32) * 0.08
    return np.clip(np.stack([v * 0.95 + dots, v * 0.92, v * 0.82], -1), 0, 1).astype(np.float32)


def _tex_fabric(n=256):
    y, x = np.mgrid[0:n, 0:n]
    weave = ((np.sin(x * np.pi / 4) * np.sin(y * np.pi / 4)) * 0.5 + 0.5) * 0.25
    v = 0.30 + weave
    return np.clip(np.stack([v * 1.5, v * 0.55, v * 0.5], -1), 0, 1).astype(np.float32)


# ---------------------------------------------------------------------------
# geometry helpers (counts/indices use quads; the loader triangulates)
# ---------------------------------------------------------------------------


class _MeshAcc:
    """Accumulates one prim's quad/tri soup with per-vertex normals + st."""

    def __init__(self):
        self.pts, self.nrm, self.st, self.idx, self.cnt = [], [], [], [], []

    def add_quad(self, p0, p1, p2, p3, uv_scale=1.0):
        base = len(self.pts)
        quad = [np.asarray(p, np.float32) for p in (p0, p1, p2, p3)]
        n = np.cross(quad[1] - quad[0], quad[3] - quad[0])
        ln = np.linalg.norm(n)
        n = n / ln if ln > 0 else np.array([0, 1, 0], np.float32)
        self.pts += quad
        self.nrm += [n] * 4
        self.st += [(0, 0), (uv_scale, 0), (uv_scale, uv_scale), (0, uv_scale)]
        self.idx += [base, base + 1, base + 2, base + 3]
        self.cnt.append(4)

    def add_box(self, center, size, uv_scale=1.0):
        c = np.asarray(center, np.float32)
        s = np.asarray(size, np.float32) * 0.5
        x, y, z = s
        corners = lambda sx, sy, sz: c + np.array([sx * x, sy * y, sz * z], np.float32)
        # 6 faces, outward winding
        f = corners
        self.add_quad(f(-1, -1, 1), f(1, -1, 1), f(1, 1, 1), f(-1, 1, 1), uv_scale)  # +z
        self.add_quad(f(1, -1, -1), f(-1, -1, -1), f(-1, 1, -1), f(1, 1, -1), uv_scale)  # -z
        self.add_quad(f(1, -1, 1), f(1, -1, -1), f(1, 1, -1), f(1, 1, 1), uv_scale)  # +x
        self.add_quad(f(-1, -1, -1), f(-1, -1, 1), f(-1, 1, 1), f(-1, 1, -1), uv_scale)  # -x
        self.add_quad(f(-1, 1, 1), f(1, 1, 1), f(1, 1, -1), f(-1, 1, -1), uv_scale)  # +y
        self.add_quad(f(-1, -1, -1), f(1, -1, -1), f(1, -1, 1), f(-1, -1, 1), uv_scale)  # -y

    def add_grid(self, origin, du, dv, nu, nv, uv_scale=1.0, height=None):
        """nu x nv quad grid on the plane spanned by du/dv from origin.
        height(u, v) optionally displaces along the plane normal."""
        o = np.asarray(origin, np.float32)
        du = np.asarray(du, np.float32)
        dv = np.asarray(dv, np.float32)
        n = np.cross(du, dv)
        n = n / max(np.linalg.norm(n), 1e-9)
        base = len(self.pts)
        us = np.linspace(0, 1, nu + 1)
        vs = np.linspace(0, 1, nv + 1)
        for v in vs:
            for u in us:
                p = o + du * u + dv * v
                if height is not None:
                    p = p + n * height(u, v)
                self.pts.append(p.astype(np.float32))
                self.nrm.append(n)
                self.st.append((u * uv_scale, v * uv_scale))
        w = nu + 1
        for j in range(nv):
            for i in range(nu):
                a = base + j * w + i
                self.idx += [a, a + 1, a + w + 1, a + w]
                self.cnt.append(4)

    def add_sphere(self, center, radius, nlat, nlon, squash=1.0):
        c = np.asarray(center, np.float32)
        base = len(self.pts)
        for j in range(nlat + 1):
            th = np.pi * j / nlat
            for i in range(nlon + 1):
                ph = 2 * np.pi * i / nlon
                n = np.array(
                    [np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)],
                    np.float32,
                )
                p = c + n * radius * np.array([1.0, squash, 1.0], np.float32)
                self.pts.append(p)
                nn = n * np.array([squash, 1.0, squash], np.float32)
                self.nrm.append(nn / max(np.linalg.norm(nn), 1e-9))
                self.st.append((i / nlon * 2.0, j / nlat))
        w = nlon + 1
        for j in range(nlat):
            for i in range(nlon):
                a = base + j * w + i
                self.idx += [a, a + w, a + w + 1, a + 1]
                self.cnt.append(4)

    def tri_count(self):
        return sum(c - 2 for c in self.cnt)


# ---------------------------------------------------------------------------
# prim-tree assembly
# ---------------------------------------------------------------------------


def _mesh_prim(path, name, acc: _MeshAcc, material: str, translate=None):
    p = Prim(type="Mesh", name=name, path=path)
    p.attrs["points"] = Attr("point3f[]", np.asarray(acc.pts, np.float32))
    p.attrs["faceVertexIndices"] = Attr("int[]", np.asarray(acc.idx, np.int64))
    p.attrs["faceVertexCounts"] = Attr("int[]", np.asarray(acc.cnt, np.int64))
    p.attrs["normals"] = Attr("normal3f[]", np.asarray(acc.nrm, np.float32))
    p.attrs["primvars:st"] = Attr("texCoord2f[]", np.asarray(acc.st, np.float32))
    p.attrs["primvars:st:__interp__"] = Attr("token", "vertex")
    p.attrs["material:binding"] = Attr("rel", targets=[material])
    if translate is not None:
        p.attrs["xformOp:translate"] = Attr("double3", tuple(float(x) for x in translate))
        p.attrs["xformOpOrder"] = Attr("token[]", ["xformOp:translate"], uniform=True)
    return p


def _shader_material(looks_path, name, *, diffuse=(0.7, 0.7, 0.7), roughness=0.5,
                     metallic=0.0, ior=1.5, opacity=1.0, emissive=None,
                     tex=None, uv_scale=None):
    mat = Prim(type="Material", name=name, path=f"{looks_path}/{name}")
    surf = Prim(type="Shader", name="S", path=f"{looks_path}/{name}/S")
    surf.attrs["info:id"] = Attr("token", "UsdPreviewSurface", uniform=True)
    surf.attrs["inputs:roughness"] = Attr("float", roughness)
    surf.attrs["inputs:metallic"] = Attr("float", metallic)
    surf.attrs["inputs:ior"] = Attr("float", ior)
    surf.attrs["inputs:opacity"] = Attr("float", opacity)
    if emissive is not None:
        surf.attrs["inputs:emissiveColor"] = Attr("color3f", tuple(emissive))
    surf.attrs["outputs:surface"] = Attr("token")
    mat.attrs["outputs:surface"] = Attr(
        "token", connect=f"{looks_path}/{name}/S.outputs:surface"
    )
    if tex is not None:
        t = Prim(type="Shader", name="T", path=f"{looks_path}/{name}/T")
        t.attrs["info:id"] = Attr("token", "UsdUVTexture", uniform=True)
        t.attrs["inputs:file"] = Attr("asset", ("__asset__", tex))
        t.attrs["outputs:rgb"] = Attr("float3")
        if uv_scale is not None:
            x = Prim(type="Shader", name="X", path=f"{looks_path}/{name}/X")
            x.attrs["info:id"] = Attr("token", "UsdTransform2d", uniform=True)
            x.attrs["inputs:scale"] = Attr("float2", (float(uv_scale), float(uv_scale)))
            t.attrs["inputs:st"] = Attr(
                "float2", connect=f"{looks_path}/{name}/X.outputs:result"
            )
            mat.children.append(x)
        surf.attrs["inputs:diffuseColor"] = Attr(
            "color3f", tuple(diffuse), connect=f"{looks_path}/{name}/T.outputs:rgb"
        )
        mat.children.append(t)
    else:
        surf.attrs["inputs:diffuseColor"] = Attr("color3f", tuple(diffuse))
    mat.children.append(surf)
    return mat


def build_kitchen_stage(out_dir: str) -> str:
    """Generate the stage + textures under out_dir; returns the .usdc path."""
    os.makedirs(os.path.join(out_dir, "textures"), exist_ok=True)
    from strelka_tpu_torch.utils.image import write_png

    for fname, fn in (
        ("checker.png", _tex_checker),
        ("wood.png", _tex_wood),
        ("wallpaper.png", _tex_wallpaper),
        ("fabric.png", _tex_fabric),
    ):
        path = os.path.join(out_dir, "textures", fname)
        if not os.path.exists(path):
            write_png(path, fn(), flip=False, as_pil=True)

    rng = np.random.default_rng(11)
    world = Prim(type="Xform", name="World", path="/World")
    looks = Prim(type="Scope", name="Looks", path="/World/Looks")
    L = "/World/Looks"

    looks.children += [
        _shader_material(L, "FloorChecker", roughness=0.35, tex="textures/checker.png", uv_scale=6.0),
        _shader_material(L, "Wallpaper", roughness=0.85, tex="textures/wallpaper.png", uv_scale=3.0),
        _shader_material(L, "Paint", diffuse=(0.82, 0.84, 0.86), roughness=0.6),
        _shader_material(L, "Wood", roughness=0.4, tex="textures/wood.png", uv_scale=2.0),
        _shader_material(L, "Fabric", roughness=0.9, tex="textures/fabric.png", uv_scale=4.0),
        _shader_material(L, "China", diffuse=(0.92, 0.9, 0.86), roughness=0.15),
        _shader_material(L, "Metal", diffuse=(0.75, 0.76, 0.78), roughness=0.25, metallic=1.0),
        _shader_material(L, "Glass", diffuse=(0.85, 0.9, 0.95), roughness=0.05, opacity=0.35, ior=1.45),
        _shader_material(L, "Leaf", diffuse=(0.2, 0.5, 0.18), roughness=0.7),
        _shader_material(L, "Fruit", diffuse=(0.85, 0.45, 0.12), roughness=0.5),
    ]

    geo = []

    def mesh(name, acc, mat, translate=None):
        geo.append(_mesh_prim(f"/World/{name}", name, acc, f"{L}/{mat}", translate))

    RW, RD, RH = 6.0, 5.0, 2.8  # room dims

    floor = _MeshAcc()
    floor.add_grid([-RW / 2, 0, -RD / 2], [RW, 0, 0], [0, 0, RD], 150, 150, uv_scale=1.0)
    mesh("floor", floor, "FloorChecker")

    ceil_ = _MeshAcc()
    ceil_.add_quad([-RW / 2, RH, -RD / 2], [RW / 2, RH, -RD / 2], [RW / 2, RH, RD / 2], [-RW / 2, RH, RD / 2])
    mesh("ceiling", ceil_, "Paint")

    walls = _MeshAcc()
    walls.add_quad([-RW / 2, 0, -RD / 2], [RW / 2, 0, -RD / 2], [RW / 2, RH, -RD / 2], [-RW / 2, RH, -RD / 2], 3.0)
    walls.add_quad([RW / 2, 0, RD / 2], [-RW / 2, 0, RD / 2], [-RW / 2, RH, RD / 2], [RW / 2, RH, RD / 2], 3.0)
    mesh("walls_wallpaper", walls, "Wallpaper")
    walls2 = _MeshAcc()
    walls2.add_quad([-RW / 2, 0, RD / 2], [-RW / 2, 0, -RD / 2], [-RW / 2, RH, -RD / 2], [-RW / 2, RH, RD / 2], 3.0)
    walls2.add_quad([RW / 2, 0, -RD / 2], [RW / 2, 0, RD / 2], [RW / 2, RH, RD / 2], [RW / 2, RH, -RD / 2], 3.0)
    mesh("walls_paint", walls2, "Paint")

    rug = _MeshAcc()
    rug.add_grid(
        [-1.4, 0.012, -0.6], [2.8, 0, 0], [0, 0, 2.0], 120, 96, uv_scale=1.0,
        height=lambda u, v: 0.004 * np.sin(u * 40) * np.sin(v * 32),
    )
    mesh("rug", rug, "Fabric")

    table = _MeshAcc()
    table.add_box([0, 0.72, 0.4], [1.6, 0.06, 1.0], uv_scale=1.0)
    for sx in (-0.7, 0.7):
        for sz in (-0.02, 0.82):
            table.add_box([sx, 0.35, sz], [0.08, 0.7, 0.08])
    mesh("table", table, "Wood")

    for k in range(6):
        ang = k * np.pi / 3 + 0.4
        cx, cz = 1.25 * np.cos(ang), 0.4 + 0.95 * np.sin(ang)
        chair = _MeshAcc()
        chair.add_box([cx, 0.45, cz], [0.42, 0.05, 0.42])
        bx = cx + 0.19 * np.cos(ang)
        bz = cz + 0.19 * np.sin(ang)
        chair.add_box([bx, 0.75, bz], [0.42 * abs(np.sin(ang)) + 0.05, 0.6, 0.42 * abs(np.cos(ang)) + 0.05])
        for dx in (-0.17, 0.17):
            for dz in (-0.17, 0.17):
                chair.add_box([cx + dx, 0.21, cz + dz], [0.05, 0.42, 0.05])
        mesh(f"chair_{k}", chair, "Wood")

    counter = _MeshAcc()
    counter.add_box([-2.55, 0.45, -1.2], [0.9, 0.9, 2.4], uv_scale=1.5)
    counter.add_box([-2.55, 0.925, -1.2], [1.0, 0.05, 2.5], uv_scale=1.5)
    counter.add_box([-2.55, 2.2, -1.2], [0.9, 0.8, 2.4], uv_scale=1.5)
    mesh("counter", counter, "Paint")
    sink = _MeshAcc()
    sink.add_box([-2.55, 0.96, -0.6], [0.55, 0.03, 0.5])
    mesh("sink", sink, "Metal")

    # dishes on the table + counter (china spheres, squashed)
    dish = _MeshAcc()
    for k in range(14):
        if k < 8:
            x = -0.6 + 0.4 * (k % 4)
            z = 0.15 + 0.5 * (k // 4)
            c = [x, 0.78, z]
        else:
            c = [-2.5, 0.99, -1.9 + 0.33 * (k - 8)]
        dish.add_sphere(c, 0.11, 16, 32, squash=0.35)
    mesh("dishes", dish, "China")

    pots = _MeshAcc()
    pots.add_sphere([-2.45, 1.12, -2.0], 0.16, 24, 48)
    pots.add_sphere([-2.6, 1.08, -1.55], 0.13, 24, 48)
    pots.add_sphere([0.45, 0.86, 0.68], 0.12, 24, 48)
    mesh("pots", pots, "Metal")

    fruit = _MeshAcc()
    for k in range(9):
        ang = k * 0.8
        fruit.add_sphere(
            [0.0 + 0.11 * np.cos(ang) * (1 + k % 2), 0.80 + 0.045 * (k // 5), 0.42 + 0.1 * np.sin(ang)],
            0.05, 12, 24,
        )
    mesh("fruit", fruit, "Fruit")

    bowl = _MeshAcc()
    bowl.add_sphere([0.0, 0.78, 0.42], 0.17, 10, 20, squash=0.5)
    mesh("bowl", bowl, "China")

    curtains = _MeshAcc()
    for cx in (1.0, 2.2):
        curtains.add_grid(
            [cx, 0.4, -RD / 2 + 0.04], [0.8, 0, 0], [0, 2.2, 0], 30, 40, uv_scale=2.0,
            height=lambda u, v: 0.05 * np.sin(u * 18.0),
        )
    mesh("curtains", curtains, "Fabric")

    plant = _MeshAcc()
    plant.add_sphere([2.5, 0.25, 2.0], 0.18, 10, 20, squash=0.9)
    for k in range(160):
        a = rng.uniform(0, 2 * np.pi)
        r0 = rng.uniform(0.02, 0.1)
        h0 = rng.uniform(0.35, 0.9)
        tip = np.array([2.5 + np.cos(a) * (r0 + 0.25), h0 + 0.25, 2.0 + np.sin(a) * (r0 + 0.25)])
        rt = np.array([2.5 + np.cos(a) * r0, h0, 2.0 + np.sin(a) * r0])
        side = np.cross(tip - rt, [0, 1, 0])
        side = 0.03 * side / max(np.linalg.norm(side), 1e-9)
        plant.add_quad(rt - side, rt + side, tip + side, tip - side)
    mesh("plant", plant, "Leaf")

    pend = _MeshAcc()
    pend.add_sphere([0.62, 0.84, 0.78], 0.09, 20, 40)
    pend.add_sphere([-2.45, 1.07, 0.1], 0.09, 20, 40)
    mesh("glassware", pend, "Glass")

    # ---- lights
    def light(ptype, name, **attrs):
        p = Prim(type=ptype, name=name, path=f"/World/{name}")
        for k, v in attrs.items():
            p.attrs[k] = v
        return p

    lights = [
        light(
            "RectLight", "window",
            **{
                "inputs:color": Attr("color3f", (1.0, 0.98, 0.92)),
                "inputs:intensity": Attr("float", 14000.0),
                "inputs:width": Attr("float", 1.8),
                "inputs:height": Attr("float", 1.6),
                "xformOp:translate": Attr("double3", (1.6, 1.5, -RD / 2 + 0.02)),
                "xformOp:rotateXYZ": Attr("double3", (0.0, 180.0, 0.0)),
                "xformOpOrder": Attr("token[]", ["xformOp:translate", "xformOp:rotateXYZ"], uniform=True),
            },
        ),
        light(
            "SphereLight", "pendant_a",
            **{
                "inputs:color": Attr("color3f", (1.0, 0.9, 0.75)),
                "inputs:intensity": Attr("float", 9000.0),
                "inputs:radius": Attr("float", 0.07),
                "xformOp:translate": Attr("double3", (0.0, 2.25, 0.4)),
                "xformOpOrder": Attr("token[]", ["xformOp:translate"], uniform=True),
            },
        ),
        light(
            "SphereLight", "pendant_b",
            **{
                "inputs:color": Attr("color3f", (1.0, 0.9, 0.75)),
                "inputs:intensity": Attr("float", 7000.0),
                "inputs:radius": Attr("float", 0.06),
                "xformOp:translate": Attr("double3", (-1.2, 2.3, -0.6)),
                "xformOpOrder": Attr("token[]", ["xformOp:translate"], uniform=True),
            },
        ),
        light(
            "DistantLight", "sun",
            **{
                "inputs:color": Attr("color3f", (1.0, 0.95, 0.85)),
                "inputs:intensity": Attr("float", 120.0),
                "inputs:angle": Attr("float", 1.5),
                "xformOp:rotateXYZ": Attr("double3", (-40.0, 30.0, 0.0)),
                "xformOpOrder": Attr("token[]", ["xformOp:rotateXYZ"], uniform=True),
            },
        ),
    ]

    cam = Prim(type="Camera", name="cam", path="/World/cam")
    cam.attrs["focalLength"] = Attr("float", 24.0)
    cam.attrs["horizontalAperture"] = Attr("float", 20.955)
    cam.attrs["verticalAperture"] = Attr("float", 20.955)
    cam.attrs["xformOp:translate"] = Attr("double3", (2.3, 1.6, 2.1))
    cam.attrs["xformOp:rotateXYZ"] = Attr("double3", (-12.0, 42.0, 0.0))
    cam.attrs["xformOpOrder"] = Attr(
        "token[]", ["xformOp:translate", "xformOp:rotateXYZ"], uniform=True
    )

    world.children = geo + [cam] + lights + [looks]
    root = Prim(name="", path="/")
    root.children = [world]
    root.metadata["defaultPrim"] = "World"

    from strelka_tpu_torch.loaders.crate import write_usdc

    usdc = os.path.join(out_dir, "kitchen.usdc")
    write_usdc(usdc, root)
    return usdc
