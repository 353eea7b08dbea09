"""Write the JAX raycaster's references of tests/test_torch_render.py to
tests/golden/render_refs.npz.

The inputs are the test module's own (`_primitive_inputs`, `_states` from
numpy generators seeded 7 and 3, the mesh model of `_mesh_models`), and
the outputs ONE jitted JAX program, as the test's fixture compiled it
(~30-40 s of XLA compile on an 8-core x86 host, nearly all of it the
twelve vmapped frame renders): JAX's five intersection functions on the
seeded rays and on them turned by +-1e-5 rad, every camera of the three
robots on three seeded states at the test's sizes, and the mesh branch.
The file holds the inputs too; the test checks them against its own.

    JAX_PLATFORMS=cpu python tools/make_golden_render.py
"""

import importlib.util
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "golden", "render_refs.npz")
ROBOTS = ("solo_arm", "dual_arm", "torso")


def test_module():
    spec = importlib.util.spec_from_file_location(
        "test_torch_render", os.path.join(ROOT, "tests", "test_torch_render.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from gym_kmanip_tpu.models import get_model as jax_model
    from gym_kmanip_tpu.render import raycast as jr

    t = test_module()
    prim = t._primitive_inputs()
    rng = np.random.default_rng(3)
    states = {name: t._states(jax_model(name), rng) for name in ROBOTS}
    jm_mesh, _ = t._mesh_models()

    def refs(prim, states):
        def per_rays(d):
            o = prim["o"]
            return dict(
                spheres=jr._ray_spheres(o, d, prim["centers"], prim["radii"]),
                capsules=jr._ray_capsules(o, d, prim["pa"], prim["pb"], prim["cap_r"]),
                box=jr._ray_box(o, d, *prim["box"]),
                triangles=jr._ray_triangles(o, d, prim["tris"]),
                floor=(jr._ray_floor(o, d),),
            )

        out = dict(prim=jax.vmap(per_rays)(prim["ds"]))
        for name, cam, (h, w) in t.FRAMES:
            jm = jax_model(name)
            out[f"{name}/{cam}"] = jax.vmap(
                lambda q, c, r: jr.render_camera(jm, cam, q, c, r, h, w))(*states[name])
        out["mesh"] = jax.vmap(
            lambda q, c, r: jr.render_camera(jm_mesh, "top", q, c, r, 12, 15))(*states["solo_arm"])
        return out

    out = jax.tree.map(np.asarray, jax.jit(refs)(prim, states))
    arrays = {}
    for key, v in prim.items():
        if key == "box":
            for i, part in enumerate(v):
                arrays[f"in/box/{i}"] = part
        else:
            arrays[f"in/{key}"] = v
    for name, (q, c, r) in states.items():
        arrays[f"in/{name}/q"], arrays[f"in/{name}/cube"], arrays[f"in/{name}/quat"] = q, c, r
    for family, outs in out.pop("prim").items():
        for i, a in enumerate(outs):
            arrays[f"prim/{family}/{i}"] = a
    for key, frames in out.items():
        arrays[f"frames/{key}"] = frames
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {os.path.abspath(OUT)}")


if __name__ == "__main__":
    main()
