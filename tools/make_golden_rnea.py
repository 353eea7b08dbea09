"""Write the JAX package's FK + RNEA references of tests/test_torch_dynamics.py
to tests/golden/rnea_refs.npz.

For the solo arm and the torso, tests/test_pallas.py:56-73's inputs (K = 4
states; numpy RandomState(0) per robot: q uniform inside jnt_range clipped
to +-3, v = 0.4 N(0, 1); float32) and the JAX seam
`kinematics.rnea_terms_fast` under vmap (frames, axes, bias forces), run
eagerly as the tests ran it; for the torso also `fk`, `all_site_poses` and
`mass_matrix_from_frames` under vmap. Eagerly these take ~15-20 s of op
compiles on an 8-core x86 host (one jit of them compiles for ~28 s), so
the tests read this file; it holds the inputs too, and the tests check
them against their own.

    JAX_PLATFORMS=cpu python tools/make_golden_rnea.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden", "rnea_refs.npz")
K = 4


def inputs(model):
    rng = np.random.RandomState(0)
    q = rng.uniform(model.jnt_range[:, 0].clip(-3), model.jnt_range[:, 1].clip(max=3),
                    (K, model.nq)).astype(np.float32)
    v = (rng.randn(K, model.nq) * 0.4).astype(np.float32)
    return q, v


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.ops import kinematics as kin

    arrays = {}
    for name in ("solo_arm", "torso"):
        jm = get_model(name)
        q, v = inputs(jm)
        arrays[f"{name}/q"], arrays[f"{name}/v"] = q, v
        seam = jax.vmap(lambda a, b: kin.rnea_terms_fast(jm, a, b))(q, v)
        for key, x in zip(("xpos", "xquat", "axis", "bias"), seam):
            arrays[f"{name}/seam/{key}"] = np.asarray(x)
        if name != "torso":
            continue
        xp, xq, ax = jax.vmap(lambda a: kin.fk(jm, a))(q)
        sp, sq = jax.vmap(lambda a, b: kin.all_site_poses(jm, a, b))(xp, xq)
        M = jax.vmap(lambda a, b, c: kin.mass_matrix_from_frames(jm, a, b, c))(xp, xq, ax)
        for key, x in (("xpos", xp), ("xquat", xq), ("axis", ax), ("site_pos", sp),
                       ("site_quat", sq), ("M", M)):
            arrays[f"{name}/fk/{key}"] = np.asarray(x)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {os.path.abspath(OUT)}")


if __name__ == "__main__":
    main()
