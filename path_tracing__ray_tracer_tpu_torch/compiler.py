"""Scene compiler: host object graph → device SoA tensors.

Port of the JAX package's ``compiler.py``.  The object-oriented ``Scene`` is
lowered once into structure-of-arrays float32 tensors on one device, with the
same wire format as the JAX package, field for field:

* SoA (x/y/z as separate tensors), one unified per-primitive material table
  in plane → sphere → quad → triangle order, indexed by global primitive id;
* primitive counts padded with *unhittable* sentinels (zero normal, zero
  radius at 1e9, degenerate triangle), so the sweeps need no validity masks;
* adjacent triangle pairs merged into parallelogram quads (``_merge_quads``);
* the texture atlas as one packed-int32 plane (0x00BBGGRR per texel) plus an
  ``[offset, width, height]`` table, path-sorted for stable ids
  (``cuda_texture_renderer.py:798-813``);
* the unique-material table ``mat_table`` with the per-primitive index
  ``mat_uid``;
* above ``BVH_THRESHOLD`` triangles (or with ``use_bvh=True``), the flat BVH
  over the triangles (``ops/bvh.FlatBVH``), its slot records carrying each
  triangle's unique-material id when the scene has a ``mat_table``.

GPU-parity mode reproduces the reference wire-format quirks: planes and
triangles never carry refraction (``cuda_texture_renderer.py:519-520,701-702``)
and planes are untextured on the device path.

:func:`compiled_scene_from_numpy` carries a JAX ``CompiledScene`` (its leaves
as numpy arrays) over into this form, so both packages can be fed identical
scene tables.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .core.camera import Camera
from .core.geometry import Plane, Sphere, Triangle
from .core.scene import Scene
from .ops.v3 import V3


class MatSoA(NamedTuple):
    """Per-primitive material table, indexed by global primitive id."""

    color: V3  # (M,)
    diffuse: torch.Tensor
    specular: torch.Tensor
    reflective: torch.Tensor
    refractive: torch.Tensor
    ior: torch.Tensor
    has_tex: torch.Tensor  # float 0/1
    tex_id: torch.Tensor  # int32, -1 when untextured


class PlanesSoA(NamedTuple):
    anchor: V3  # (P,)
    normal: V3
    u_unit: V3
    v_unit: V3
    u_len: torch.Tensor
    v_len: torch.Tensor


class SpheresSoA(NamedTuple):
    center: V3  # (S,)
    radius: torch.Tensor


class TrianglesSoA(NamedTuple):
    v0: V3  # (T,)
    v1: V3
    v2: V3
    normal: V3
    uv0: Tuple[torch.Tensor, torch.Tensor]
    uv1: Tuple[torch.Tensor, torch.Tensor]
    uv2: Tuple[torch.Tensor, torch.Tensor]


class QuadsSoA(NamedTuple):
    """Parallelogram quads merged from adjacent triangle pairs.  ``du``/``dv``
    are the dual vectors of the edge basis, so the in-plane coordinates are
    ``a = (p − origin)·du`` and ``b = (p − origin)·dv``, hit iff
    ``0 ≤ a,b ≤ 1``.  Double-sided, normal flipped toward the ray."""

    origin: V3  # (Q,)
    eu: V3
    ev: V3
    normal: V3
    du: V3
    dv: V3
    uv0: Tuple[torch.Tensor, torch.Tensor]  # UV at origin
    uva: Tuple[torch.Tensor, torch.Tensor]  # d(UV)/da
    uvb: Tuple[torch.Tensor, torch.Tensor]  # d(UV)/db


class CompiledScene(NamedTuple):
    planes: PlanesSoA
    spheres: SpheresSoA
    quads: QuadsSoA
    triangles: TrianglesSoA
    materials: MatSoA  # size P + S + Q + T (global primitive order)
    lights: V3  # (L,) point samples of area lights
    light_color: V3  # 0-d
    ambient: V3  # 0-d
    atlas: torch.Tensor  # (Npix,) int32, 0x00BBGGRR packed texels
    tex_offset: torch.Tensor  # (T,) int32, in texels
    tex_width: torch.Tensor
    tex_height: torch.Tensor
    device: torch.device  # every tensor above and below lives here
    bvh: object = None  # Optional[ops.bvh.FlatBVH] over the triangles (big scenes)
    # optional low-resolution mip of the atlas (``mip_budget`` compile arg):
    # the deferred-texture and texture-LOD modes of the path tracer
    mip_atlas: Optional[torch.Tensor] = None
    mip_offset: Optional[torch.Tensor] = None
    mip_width: Optional[torch.Tensor] = None
    mip_height: Optional[torch.Tensor] = None
    # shape-encoded flags, kept as in the JAX package: (1,) int8 when any
    # TRIANGLE material is textured / when ANY primitive is textured, else (0,)
    tri_uv_used: Optional[torch.Tensor] = None
    any_textured: Optional[torch.Tensor] = None
    # unique-material compression: (M,) int32 prim → unique row, and the
    # (U,) unique rows; None when the scene has more than SELECT_LIMIT rows
    mat_uid: Optional[torch.Tensor] = None
    mat_table: Optional[MatSoA] = None

    @property
    def n_planes(self) -> int:
        return int(self.planes.u_len.shape[0])

    @property
    def n_spheres(self) -> int:
        return int(self.spheres.radius.shape[0])

    @property
    def n_quads(self) -> int:
        return int(self.quads.uv0[0].shape[0])

    @property
    def n_triangles(self) -> int:
        return int(self.triangles.uv0[0].shape[0])

    @property
    def n_lights(self) -> int:
        return int(self.lights.x.shape[0])

    @property
    def n_textures(self) -> int:
        return int(self.tex_offset.shape[0])


# triangle count above which the scene gets a flat BVH
BVH_THRESHOLD = 256
# largest unique-material table the JAX package compresses (its select_table)
SELECT_LIMIT = 128


def _pad_to(n: int) -> int:
    """Padded primitive count: at least 1, so gathers stay well-defined."""
    return max(1, n)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _v3_table(vecs: List, pad: int, device, fill=(0.0, 0.0, 0.0)) -> V3:
    arr = np.full((pad, 3), fill, dtype=np.float32)
    for i, v in enumerate(vecs):
        arr[i] = (v.x, v.y, v.z)
    return V3(_tensor(arr[:, 0], device), _tensor(arr[:, 1], device), _tensor(arr[:, 2], device))


def _f32_table(vals: List[float], pad: int, device, fill=0.0) -> torch.Tensor:
    arr = np.full((pad,), fill, dtype=np.float32)
    arr[: len(vals)] = vals
    return _tensor(arr, device)


def _merge_quads(tris: List[Triangle]):
    """Merge adjacent triangle pairs into parallelogram quads.

    A pair (i, i+1) merges when it forms the two halves of a parallelogram
    with a consistent bilinear UV map — the pattern every quad-emitting
    builder produces: ``(q0, q1, q2)`` + ``(q0, q2, q3)`` with
    ``q2 == q1 + q3 − q0``.  Returns ``(quad_records, leftover_triangles)``;
    each record is ``(origin, eu, ev, normal, uv0, uva, uvb, material)``.
    """

    def uv_of(t, which):
        # reference wire-format defaults for missing vertex UVs
        # (cuda_texture_renderer.py:869-874)
        defaults = {0: (0.0, 0.0), 1: (1.0, 0.0), 2: (1.0, 1.0)}
        uv = (t.uv0, t.uv1, t.uv2)[which]
        return (
            (float(uv[0]), float(uv[1])) if uv is not None else defaults[which]
        )

    # Pair by shared diagonal edge via a hash (the scene's BVH build sorts
    # the object list in place — reference behavior — so pairs are not
    # adjacent).  A t1=(q0,q1,q2) matches a t2=(q0,q2,q3): key both by the
    # quantized (v0, shared-vertex) edge + material identity.
    def quant(v):
        return (round(v.x, 5), round(v.y, 5), round(v.z, 5))

    by_edge = {}
    for j, t in enumerate(tris):
        by_edge.setdefault((quant(t.v0), quant(t.v1), id(t.material)), []).append(j)

    used = [False] * len(tris)
    quads, leftovers = [], []
    for i, t1 in enumerate(tris):
        if used[i]:
            continue
        merged = False
        for j in by_edge.get((quant(t1.v0), quant(t1.v2), id(t1.material)), []):
            if j == i or used[j]:
                continue
            t2 = tris[j]
            q0, q1, q2, q3 = t1.v0, t1.v1, t1.v2, t2.v2
            scale = max((q1 - q0).length(), (q3 - q0).length(), 1e-6)
            if (q2 - (q1 + q3 - q0)).length() >= 1e-5 * scale:
                continue
            uv0 = np.array(uv_of(t1, 0))
            uv1 = np.array(uv_of(t1, 1))
            uv2 = np.array(uv_of(t1, 2))
            uv3 = np.array(uv_of(t2, 2))
            uv_ok = (
                np.abs(uv2 - (uv1 + uv3 - uv0)).max() < 1e-5
                and np.abs(np.array(uv_of(t2, 0)) - uv0).max() < 1e-5
                and np.abs(np.array(uv_of(t2, 1)) - uv2).max() < 1e-5
            )
            if not uv_ok:
                continue
            eu, ev = q1 - q0, q3 - q0
            n = eu.cross(ev)
            if n.dot(n) <= 1e-12:
                continue
            du = ev.cross(n) / ev.cross(n).dot(eu)
            dv = n.cross(eu) / n.cross(eu).dot(ev)
            quads.append(
                (q0, eu, ev, n.normalize(), du, dv,
                 tuple(uv0), tuple(uv1 - uv0), tuple(uv3 - uv0), t1.material)
            )
            used[i] = used[j] = True
            merged = True
            break
        if not merged:
            leftovers.append(t1)
    return quads, leftovers


def collect_texture_paths(scene: Scene) -> List[str]:
    """All distinct texture paths, sorted — the reference's stable-ID rule
    (``cuda_texture_renderer.py:798-813``)."""
    paths: List[str] = []
    for obj in scene.objects:
        mat = getattr(obj, "material", None)
        if mat is not None and mat.texture is not None:
            path = getattr(mat.texture, "path", None)
            if path and path not in paths:
                paths.append(path)
    return sorted(paths)


def compile_scene(
    scene: Scene,
    convention: str = "gpu",
    gpu_parity: bool = True,
    texture_budget: int = 0,
    mip_budget: int = 0,
    device="cuda",
    use_bvh: Optional[bool] = None,
) -> CompiledScene:
    """Lower a host ``Scene`` to the device SoA form on ``device``.

    ``convention`` selects the plane V-axis rule: ``"gpu"`` normalizes the
    given ``v_dir`` (``cuda_renderer.py:336-341``); ``"cpu"`` derives
    ``v = normal × u``.  ``gpu_parity`` reproduces the wire-format quirks of
    the reference GPU flatteners (see module doc).  ``texture_budget`` caps
    each texture's max dimension (box-filter downsample); 0 keeps the
    reference-exact full resolution.  ``mip_budget`` > 0 adds a second,
    smaller atlas capped the same way (``mip_*`` fields), which the path
    tracer's deferred-texture and texture-LOD modes sample.  ``use_bvh``
    forces the flat BVH on (``True``) or off (``False``); by default a scene
    gets one above ``BVH_THRESHOLD`` triangles after the quad merge.
    """
    device = torch.device(device)
    planes = [o for o in scene.objects if isinstance(o, Plane)]
    spheres = [o for o in scene.objects if isinstance(o, Sphere)]
    tris = [o for o in scene.objects if isinstance(o, Triangle)]
    quad_recs, tris = _merge_quads(tris)

    texture_paths = collect_texture_paths(scene)
    tex_ids = {p: i for i, p in enumerate(texture_paths)}

    p_pad, s_pad, t_pad = _pad_to(len(planes)), _pad_to(len(spheres)), _pad_to(len(tris))
    q_pad = _pad_to(len(quad_recs))

    def v3(vecs, pad, fill=(0.0, 0.0, 0.0)):
        return _v3_table(vecs, pad, device, fill)

    def f32(vals, pad, fill=0.0):
        return _f32_table(vals, pad, device, fill)

    # ---- geometry tables ---------------------------------------------------
    plane_v_units = []
    for pl in planes:
        if convention == "gpu":
            plane_v_units.append(pl.v_dir.normalize())
        else:
            plane_v_units.append(pl.normal.cross(pl.u_dir.normalize()).normalize())

    planes_soa = PlanesSoA(
        anchor=v3([p.anchor for p in planes], p_pad),
        normal=v3([p.normal for p in planes], p_pad),  # zero normal = unhittable pad
        u_unit=v3([p.u_unit for p in planes], p_pad),
        v_unit=v3(plane_v_units, p_pad),
        u_len=f32([p.u_len for p in planes], p_pad, fill=1.0),
        v_len=f32([p.v_len for p in planes], p_pad, fill=1.0),
    )
    spheres_soa = SpheresSoA(
        # zero radius at 1e9 → discriminant never strictly positive
        center=v3([s.center for s in spheres], s_pad, fill=(0.0, 0.0, 1e9)),
        radius=f32([s.radius for s in spheres], s_pad, fill=0.0),
    )

    def _uv_pair(uvs, default):
        u = f32([float(t[0]) if t is not None else default[0] for t in uvs], t_pad)
        v = f32([float(t[1]) if t is not None else default[1] for t in uvs], t_pad)
        return (u, v)

    tris_soa = TrianglesSoA(
        v0=v3([t.v0 for t in tris], t_pad),  # degenerate (all-zero) pad tri
        v1=v3([t.v1 for t in tris], t_pad),
        v2=v3([t.v2 for t in tris], t_pad),
        normal=v3([t.normal for t in tris], t_pad),
        # reference default UVs for missing vertex UVs: (0,0),(1,0),(1,1)
        # (cuda_texture_renderer.py:869-874)
        uv0=_uv_pair([t.uv0 for t in tris], (0.0, 0.0)),
        uv1=_uv_pair([t.uv1 for t in tris], (1.0, 0.0)),
        uv2=_uv_pair([t.uv2 for t in tris], (1.0, 1.0)),
    )

    def _uv_scalar_pair(vals, pad):
        return (f32([v[0] for v in vals], pad), f32([v[1] for v in vals], pad))

    quads_soa = QuadsSoA(
        origin=v3([q[0] for q in quad_recs], q_pad),
        eu=v3([q[1] for q in quad_recs], q_pad),
        ev=v3([q[2] for q in quad_recs], q_pad),
        normal=v3([q[3] for q in quad_recs], q_pad),  # zero normal pad
        du=v3([q[4] for q in quad_recs], q_pad),
        dv=v3([q[5] for q in quad_recs], q_pad),
        uv0=_uv_scalar_pair([q[6] for q in quad_recs] or [(0.0, 0.0)], q_pad),
        uva=_uv_scalar_pair([q[7] for q in quad_recs] or [(0.0, 0.0)], q_pad),
        uvb=_uv_scalar_pair([q[8] for q in quad_recs] or [(0.0, 0.0)], q_pad),
    )

    # ---- unified material table (plane → sphere → quad → triangle order) ----
    m_total = p_pad + s_pad + q_pad + t_pad
    color = np.zeros((m_total, 3), dtype=np.float32)
    diffuse = np.zeros(m_total, dtype=np.float32)
    specular = np.zeros(m_total, dtype=np.float32)
    reflective = np.zeros(m_total, dtype=np.float32)
    refractive = np.zeros(m_total, dtype=np.float32)
    ior = np.ones(m_total, dtype=np.float32)
    has_tex = np.zeros(m_total, dtype=np.float32)
    tex_id = np.full(m_total, -1, dtype=np.int32)

    def _fill(row: int, mat, allow_refraction: bool, allow_texture: bool):
        color[row] = (mat.color.x, mat.color.y, mat.color.z)
        diffuse[row] = mat.diffuse
        specular[row] = mat.specular
        reflective[row] = mat.reflective
        refractive[row] = mat.refractive if allow_refraction else 0.0
        ior[row] = mat.ior if allow_refraction else 1.0
        if allow_texture and mat.texture is not None:
            path = getattr(mat.texture, "path", None)
            if path in tex_ids:
                has_tex[row] = 1.0
                tex_id[row] = tex_ids[path]

    for i, p in enumerate(planes):
        _fill(i, p.material, allow_refraction=not gpu_parity, allow_texture=not gpu_parity)
    for i, s in enumerate(spheres):
        _fill(p_pad + i, s.material, allow_refraction=True, allow_texture=not gpu_parity)
    for i, q in enumerate(quad_recs):
        _fill(p_pad + s_pad + i, q[9], allow_refraction=not gpu_parity, allow_texture=True)
    for i, t in enumerate(tris):
        _fill(p_pad + s_pad + q_pad + i, t.material, allow_refraction=not gpu_parity,
              allow_texture=True)

    def mat_soa(cols, tex):
        return MatSoA(
            color=V3(_tensor(cols[0], device), _tensor(cols[1], device), _tensor(cols[2], device)),
            diffuse=_tensor(cols[3], device),
            specular=_tensor(cols[4], device),
            reflective=_tensor(cols[5], device),
            refractive=_tensor(cols[6], device),
            ior=_tensor(cols[7], device),
            has_tex=_tensor(cols[8], device),
            tex_id=_tensor(tex, device),
        )

    materials = mat_soa(
        (color[:, 0], color[:, 1], color[:, 2], diffuse, specular, reflective,
         refractive, ior, has_tex), tex_id,
    )

    # ---- unique-material compression ----------------------------------------
    mat_rows = np.stack(
        [color[:, 0], color[:, 1], color[:, 2], diffuse, specular,
         reflective, refractive, ior, has_tex, tex_id.astype(np.float64)],
        axis=1,
    )
    uniq, uid = np.unique(mat_rows, axis=0, return_inverse=True)
    uid = uid.reshape(-1)  # numpy 2.x returns (M, 1) for axis-unique inverse
    mat_uid = mat_table = None
    if uniq.shape[0] <= SELECT_LIMIT:
        uq = uniq.astype(np.float32)
        mat_uid = _tensor(uid.astype(np.int32), device)
        mat_table = mat_soa(tuple(uq[:, k] for k in range(9)), uniq[:, 9].astype(np.int32))

    # ---- lights & globals ----------------------------------------------------
    lights = v3(scene.lights, max(1, len(scene.lights)))
    if not scene.lights:
        lights = V3(lights.x[:0], lights.y[:0], lights.z[:0])  # truly empty

    atlas, offs, ws, hs = _build_atlas(texture_paths, texture_budget)
    mip = (None,) * 4
    if mip_budget:
        mip = tuple(_tensor(a, device) for a in _build_atlas(texture_paths, mip_budget))
    tri_textured = any(
        t.material is not None and t.material.texture is not None for t in tris
    )

    def flag(on: bool):
        return torch.zeros((1 if on else 0,), dtype=torch.int8, device=device)

    cs = CompiledScene(
        planes=planes_soa,
        spheres=spheres_soa,
        quads=quads_soa,
        triangles=tris_soa,
        materials=materials,
        lights=lights,
        light_color=V3.of(scene.light_color.x, scene.light_color.y, scene.light_color.z,
                          device=device),
        ambient=V3.of(scene.ambient.x, scene.ambient.y, scene.ambient.z, device=device),
        atlas=_tensor(atlas, device),
        tex_offset=_tensor(offs, device),
        tex_width=_tensor(ws, device),
        tex_height=_tensor(hs, device),
        device=device,
        tri_uv_used=flag(tri_textured),
        any_textured=flag(bool(np.any(has_tex > 0.0))),
        mat_uid=mat_uid,
        mat_table=mat_table,
        mip_atlas=mip[0],
        mip_offset=mip[1],
        mip_width=mip[2],
        mip_height=mip[3],
    )
    if use_bvh is None:
        use_bvh = len(tris) > BVH_THRESHOLD
    if use_bvh and tris:
        cs = _with_bvh(cs, tris, uid if mat_uid is not None else None, p_pad + s_pad + q_pad)
    return cs


def _with_bvh(cs: CompiledScene, tris: List[Triangle], uid, tri_base: int) -> CompiledScene:
    """``cs`` with the flat BVH over ``tris``: triangle AABBs, the stored
    normals in the slot records, and each triangle's unique-material id
    (``uid`` of the global primitive order) packed into its slot gid while
    the counts fit the f32-exact packing range; a big tree also gets its
    paged layout (``ops/bvh.to_device``)."""
    from .ops import bvh as bvh_mod
    from .ops.cuda.bounce import pack_ps_blob

    v0, v1, v2, nrm = (np.stack([getattr(t, f).to_np() for t in tris])
                       for f in ("v0", "v1", "v2", "normal"))
    tri_uid = None
    if uid is not None and len(tris) <= bvh_mod.GID_UID_SHIFT:
        tri_uid = uid[tri_base: tri_base + len(tris)].astype(np.int32)
    arrs = bvh_mod.build_bvh(np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2))
    flat = bvh_mod.to_device(arrs, v0, v1, v2, nrm, uid=tri_uid, device=cs.device)
    return cs._replace(bvh=flat._replace(ps_blob=pack_ps_blob(cs)))


def _build_atlas(texture_paths: List[str], texture_budget: int = 0):
    """Concatenate all textures row-major into one packed-int32 atlas
    (``cuda_texture_renderer.py:910-955``): one int32 per texel, 0x00BBGGRR.
    Returns numpy ``(atlas, offsets, widths, heights)``."""
    from PIL import Image

    chunks = []
    offs, ws, hs = [], [], []
    offset = 0
    for path in texture_paths:
        try:
            with Image.open(path) as img:
                rgb = img.convert("RGB")
                if texture_budget and max(rgb.size) > texture_budget:
                    scale = texture_budget / max(rgb.size)
                    rgb = rgb.resize(
                        (max(1, int(rgb.size[0] * scale)),
                         max(1, int(rgb.size[1] * scale))),
                        Image.BOX,
                    )
                pixels = np.asarray(rgb, dtype=np.uint8)
            h, w = pixels.shape[:2]
            chunks.append(pixels.reshape(-1, 3))
            offs.append(offset)
            ws.append(w)
            hs.append(h)
            offset += w * h
        except OSError:
            # reference fallback: a 1×1 white texel (cuda_texture_renderer.py:948-953)
            chunks.append(np.full((1, 3), 255, dtype=np.uint8))
            offs.append(offset)
            ws.append(1)
            hs.append(1)
            offset += 1

    if chunks:
        flat = np.concatenate(chunks, axis=0)
    else:
        flat = np.full((1, 3), 255, dtype=np.uint8)
        offs, ws, hs = [0], [1], [1]

    flat32 = flat.astype(np.int32)
    packed = flat32[:, 0] | (flat32[:, 1] << 8) | (flat32[:, 2] << 16)
    return (
        packed,
        np.asarray(offs, dtype=np.int32),
        np.asarray(ws, dtype=np.int32),
        np.asarray(hs, dtype=np.int32),
    )


def pack_camera(camera: Camera, device="cuda") -> torch.Tensor:
    """Camera 12-float wire format (``cuda_renderer.py:655-662``)."""
    return _tensor(camera.packed(), torch.device(device))


def scene_summary(cs: CompiledScene) -> dict:
    return {
        "planes": cs.n_planes,
        "spheres": cs.n_spheres,
        "quads": cs.n_quads,
        "triangles": cs.n_triangles,
        "lights": cs.n_lights,
        "textures": cs.n_textures,
        "atlas_pixels": int(cs.atlas.shape[0]),
        "device": str(cs.device),
    }


# ---- carrying a JAX CompiledScene across -------------------------------------
_SOA_TYPES = {c.__name__: c for c in (V3, MatSoA, PlanesSoA, SpheresSoA, TrianglesSoA, QuadsSoA)}


def _from_numpy(obj, device):
    if obj is None:
        return None
    cls = _SOA_TYPES.get(type(obj).__name__)
    if cls is not None:
        return cls(*(_from_numpy(getattr(obj, f), device) for f in cls._fields))
    if isinstance(obj, tuple):
        return tuple(_from_numpy(o, device) for o in obj)
    return torch.from_numpy(np.array(obj)).to(device)


def compiled_scene_from_numpy(tree, device="cuda") -> CompiledScene:
    """The port's ``CompiledScene`` on ``device`` from a JAX ``CompiledScene``
    whose leaves are numpy arrays (e.g. ``jax.tree.map(np.asarray, cs)``).
    Sub-records are matched by class and field name, so every field is
    carried over unchanged; a flat BVH brings its node arrays, its BVH2 and
    BVH4 node records and its slot records, a paged tree its paged layout
    (with the port's padded page slot copy, ``ops/bvh.pack_page_slot16``), a
    one-level tree its leaf coefficient table, and a ``mip_budget`` scene its
    mip atlas."""
    device = torch.device(device)
    fields = {f: _from_numpy(getattr(tree, f), device)
              for f in CompiledScene._fields if f not in ("device", "bvh")}
    cs = CompiledScene(device=device, **fields)
    if tree.bvh is None:
        return cs
    from .ops import bvh as bvh_mod
    from .ops.cuda.bounce import pack_ps_blob

    b = tree.bvh
    arrs = {k: np.asarray(getattr(b, k)) for k in ("lo", "hi", "skip", "is_leaf", "slots")}
    if b.quad_blob is not None:
        nodes4, depth4 = np.asarray(b.quad_blob), int(b.quad_depth_token.shape[0])
        node2 = bvh_mod.pack_blobs4(arrs)[2]  # the JAX package keeps no such map
    else:
        nodes4, depth4, node2 = bvh_mod._root_leaf_node4(arrs), 1, np.zeros(1, np.int64)

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)  # a copy: JAX's arrays are read-only

    paged = None
    if b.paged is not None:
        pg = b.paged
        top_tree = np.asarray(pg.top_tree)[0]
        n_pages = int(np.asarray(pg.page_tree).shape[0])
        page_slot = t(pg.page_slot)
        paged = bvh_mod.PagedBlobs(
            top_tree=t(top_tree), top_slot=t(np.asarray(pg.top_slot)[0]),
            page_tree=t(pg.page_tree), page_slot=page_slot,
            page_slot16=bvh_mod.pack_page_slot16(page_slot),
            top_depth=int(pg.top_depth_token.shape[0]),
            page_depth=int(pg.page_depth_token.shape[0]), page_lo=t(pg.page_lo),
            page_hi=t(pg.page_hi), page_root=t(bvh_mod.page_roots(arrs, top_tree, n_pages)))
    slot_rec = t(np.asarray(b.slot_blob)[0])
    flat = bvh_mod.FlatBVH(**{k: t(a) for k, a in arrs.items()}, nodes4=t(nodes4[0]),
                           slot_rec=slot_rec, slot16=bvh_mod.pack_slot16(slot_rec), depth4=depth4,
                           uid_packed=b.uid_token is not None, tree2=t(np.asarray(b.tree_blob)[0]),
                           depth2=int(b.depth_token.shape[0]), node2=t(node2), paged=paged,
                           leaf_mat=None if paged is not None or b.leaf_mat is None
                           else t(b.leaf_mat))
    return cs._replace(bvh=flat._replace(ps_blob=pack_ps_blob(cs)))
