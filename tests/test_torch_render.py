"""The port's raycaster (render/raycast.py) against the JAX package's
`gym_kmanip_tpu/render/raycast.py`, on the CPU.

The JAX package's outputs are read from tests/golden/render_refs.npz,
written by `python tools/make_golden_render.py` from this module's own
inputs with ONE jitted JAX program (~30-40 s of XLA compile on an 8-core
x86 host, nearly all of it the twelve vmapped frame renders); the file
holds the inputs too, and the fixture checks them against its own:
- JAX's five intersection functions on the same seeded rays, each ray set
  also turned by 1e-5 rad two ways, so that a ray whose JAX hit or normal
  changes under that turn counts as grazing;
- every camera of the solo arm, the dual arm and the torso on three
  seeded states, each at one of 12 x 15 (an odd side) and 16 x 20, so
  that each robot and each kind of camera (world-fixed, body-mounted)
  renders at both sizes;
- the mesh branch, on the solo arm with two triangles added (one on a
  joint, one in the world).

Bands: where both hit, t within 1e-5 max(1, t); the hit masks equal away
from grazing rays; the normals within 1e-5 (a sphere's or a capsule's as
hit point minus axis point, at t's band: the unit normal carries t's
rounding divided by the radius). The uint8 frames within one level on at
least 99.5% of the pixels (the share is printed; measured: 99.79% for one
torso frame, 100% for the others).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gym_kmanip_tpu.models import get_model as jax_model
from gym_kmanip_tpu.models.spec import MeshGeomSpec as JMeshGeomSpec
from gym_kmanip_tpu.render import raycast as jr

from gym_kmanip_torch.models import from_numpy_model, get_model
from gym_kmanip_torch.render import raycast as tr

torch.set_num_threads(1)

B = 3
# (robot, camera, (h, w))
FRAMES = [
    ("solo_arm", "grip_r", (12, 15)), ("solo_arm", "top", (16, 20)),
    ("solo_arm", "head", (12, 15)),
    ("dual_arm", "grip_r", (16, 20)), ("dual_arm", "grip_l", (12, 15)),
    ("dual_arm", "top", (12, 15)), ("dual_arm", "head", (16, 20)),
    ("torso", "grip_r", (12, 15)), ("torso", "grip_l", (16, 20)),
    ("torso", "top", (16, 20)), ("torso", "head", (12, 15)),
]
MESH_TRIS = (
    # on joint 4 of the solo arm (its frame), and in the world over the table
    (4, np.array([[[0.0, 0.0, 0.0], [0.12, 0.0, 0.0], [0.0, 0.12, 0.02]]], np.float32)),
    (-1, np.array([[[-0.25, 0.45, 0.66], [0.35, 0.45, 0.66], [0.05, 0.85, 0.70]]], np.float32)),
)
P = 192
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "render_refs.npz")
FAMILIES = ("spheres", "capsules", "box", "triangles", "floor")


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _turn(d, axis, angle):
    """Rotate each ray d (P, 3) by `angle` about axis x d."""
    k = _unit(np.cross(axis, d))
    return d * np.cos(angle) + np.cross(k, d) * np.sin(angle) + k * np.sum(k * d, -1,
                                                                         keepdims=True) * (
        1 - np.cos(angle))


def _primitive_inputs():
    rng = np.random.default_rng(7)
    o = rng.uniform([-0.3, 0.0, 0.8], [0.3, 0.6, 1.2], (P, 3))
    centers = rng.uniform([-0.2, 0.2, 0.4], [0.2, 0.6, 0.7], (5, 3))
    radii = rng.uniform(0.03, 0.15, 5)
    pa = rng.uniform([-0.2, 0.2, 0.4], [0.2, 0.6, 0.7], (4, 3))
    pb = pa + rng.uniform(-0.2, 0.2, (4, 3))
    cap_r = rng.uniform(0.02, 0.08, 4)
    q = _unit(rng.normal(size=4))
    w, x, y, z = q
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    box = (np.array([0.0, 0.4, 0.55]), R, np.array([0.15, 0.1, 0.08]))
    tris = rng.uniform([-0.3, 0.1, 0.3], [0.3, 0.7, 0.7], (4, 3, 3))
    # aim at the primitives' region, with a spread that misses as well
    d = _unit(rng.uniform([-0.3, 0.1, 0.3], [0.3, 0.7, 0.7], (P, 3)) - o
              + rng.normal(0, 0.08, (P, 3)))
    d[: P // 8] = _unit(rng.normal(size=(P // 8, 3)))  # some point anywhere
    axis = rng.normal(size=3)
    ds = np.stack([d, _turn(d, axis, 1e-5), _turn(d, axis, -1e-5)])
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(o=f32(o), ds=f32(ds), centers=f32(centers), radii=f32(radii), pa=f32(pa),
                pb=f32(pb), cap_r=f32(cap_r), box=tuple(f32(b) for b in box), tris=f32(tris))


def _states(model, rng):
    q = (model.home_qpos + rng.uniform(-0.3, 0.3, (B, model.nq))).astype(np.float32)
    cube = rng.uniform([0.1, 0.5, 0.6], [0.3, 0.7, 0.7], (B, 3)).astype(np.float32)
    quat = _unit(rng.normal(size=(B, 4)) + [3.0, 0, 0, 0]).astype(np.float32)
    return q, cube, quat


def _mesh_models():
    jm = jax_model("solo_arm")
    meshes = tuple(JMeshGeomSpec(f"tri{i}", parent, tris)
                   for i, (parent, tris) in enumerate(MESH_TRIS))
    jm_mesh = dataclasses.replace(jm, meshes=meshes)
    return jm_mesh, from_numpy_model(jm_mesh)


@pytest.fixture(scope="module")
def jax_refs():
    prim = _primitive_inputs()
    rng = np.random.default_rng(3)
    states = {name: _states(jax_model(name), rng) for name in ("solo_arm", "dual_arm", "torso")}
    with np.load(GOLDEN) as g:
        ref = {key: g[key] for key in g.files}
    # the golden was made from these inputs
    for key, v in prim.items():
        for i, part in enumerate(v) if key == "box" else ((None, v),):
            name = f"in/{key}" if i is None else f"in/{key}/{i}"
            np.testing.assert_array_equal(ref[name], part, err_msg=name)
    for name, arrays in states.items():
        for part, a in zip(("q", "cube", "quat"), arrays):
            np.testing.assert_array_equal(ref[f"in/{name}/{part}"], a, err_msg=name)
    n_outs = {f: sum(key.startswith(f"prim/{f}/") for key in ref) for f in FAMILIES}
    out = dict(prim={f: tuple(ref[f"prim/{f}/{i}"] for i in range(n)) for f, n in n_outs.items()})
    out.update({key[len("frames/"):]: v for key, v in ref.items() if key.startswith("frames/")})
    return prim, states, out


@pytest.mark.parametrize("family", FAMILIES)
def test_intersections_match_jax(jax_refs, family):
    prim, _, ref = jax_refs
    o, d = torch.as_tensor(prim["o"]), torch.as_tensor(prim["ds"][0])
    t_ = torch.as_tensor
    got = {
        "spheres": lambda: tr._ray_spheres(o, d, t_(prim["centers"]), t_(prim["radii"])),
        "capsules": lambda: tr._ray_capsules(o, d, t_(prim["pa"]), t_(prim["pb"]),
                                             t_(prim["cap_r"])),
        "box": lambda: tr._ray_box(o, d, *map(t_, prim["box"])),
        "triangles": lambda: tr._ray_triangles(o, d, t_(prim["tris"])),
        "floor": lambda: (tr._ray_floor(o, d),),
    }[family]()
    want = ref["prim"][family]  # each output with the three ray sets leading
    hit3 = want[0] < jr._BIG
    t_got, t_want, hit_want = got[0].numpy(), want[0][0], hit3[0]
    hit_got = t_got < jr._BIG
    assert hit_want.any() and (~hit_want).any(), "the rays should hit and miss"
    # away from grazing: the JAX hit is the same for the turned rays
    steady = np.all(hit3 == hit_want, axis=0)
    assert steady.mean() > 0.9
    np.testing.assert_array_equal(hit_got[steady], hit_want[steady])
    both = hit_got & hit_want
    atol = 1e-5 * max(1.0, float(t_want[both].max()))
    np.testing.assert_allclose(t_got[both], t_want[both], rtol=0, atol=atol)
    if family == "floor":
        return
    n3 = want[1]
    # a box edge or a capsule's cap seam: the normal jumps under the turn
    smooth = both & hit3.all(axis=0) & np.all(np.abs(n3 - n3[0]) < 1e-3, axis=(0, -1))
    assert smooth.sum() > 10
    n_got, n_want = got[1].numpy(), n3[0]
    if family in ("spheres", "capsules"):
        # the normal is (hit point - axis point) / r: held as that offset,
        # at t's band (it carries t's rounding, 1 / r larger in the normal)
        r = prim["radii"] if family == "spheres" else prim["cap_r"]
        n_got, n_want = n_got * r[:, None], n_want * r[:, None]
    else:
        atol = 1e-5
    np.testing.assert_allclose(n_got[smooth], n_want[smooth], atol=atol, rtol=0)


def _share_within_one(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
    return float((diff <= 1).mean())


@pytest.mark.parametrize("name,cam,hw", FRAMES)
def test_frames_match_jax(jax_refs, name, cam, hw):
    """One call renders the batch of three states; JAX vmaps."""
    _, states, ref = jax_refs
    q, c, r = (torch.as_tensor(a) for a in states[name])
    got = tr.render_camera(get_model(name), cam, q, c, r, *hw).numpy()
    want = ref[f"{name}/{cam}"]
    assert got.dtype == np.uint8 and got.shape == want.shape == (B,) + hw + (3,)
    share = _share_within_one(got, want)
    print(f"{name} {cam} {hw}: {share:.2%} of pixels within one level")
    assert share >= 0.995, share
    assert got.std() > 0
    # one call over the batch equals a call per state
    for i in range(B):
        np.testing.assert_array_equal(
            tr.render_camera(get_model(name), cam, q[i], c[i], r[i], *hw).numpy(), got[i])


def test_mesh_branch_matches_jax(jax_refs):
    _, states, ref = jax_refs
    _, model = _mesh_models()
    q, c, r = (torch.as_tensor(a) for a in states["solo_arm"])
    got = tr.render_camera(model, "top", q, c, r, 12, 15).numpy()
    without = tr.render_camera(get_model("solo_arm"), "top", q, c, r, 12, 15).numpy()
    share = _share_within_one(got, ref["mesh"])
    print(f"mesh: {share:.2%} of pixels within one level")
    assert share >= 0.995, share
    # the triangles show: pixels change where they are
    assert np.any(got != without, axis=-1).sum() >= 5
