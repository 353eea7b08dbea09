"""VR teleoperation through Vuer / WebXR.

Port of `gym_kmanip_tpu/examples/4_teleop.py`: a Vuer app streams hand
tracking at ~30 fps, gym_kmanip_torch.teleop maps it to EE and grip
actions (both hands on bimanual robots, orientation from the wrist
rotation, the gripper from the thumb-middle pinch distance, a thumb-pinky
reset with a 1 s backoff), and the session loop steps the env and upserts
the scene (the URDF robot with its joint values, cube, table, hand
spheres) at ~60 fps.

vuer is optional and imported by `main()`, which raises without it; this
module imports without it. `build_app` takes the Vuer surface as
arguments, so a mock Vuer can replay recorded hand frames through it.
Run, then open the printed URL in a WebXR browser or headset.

    python -m gym_kmanip_torch.examples.4_teleop
"""

import asyncio
import time

from gym_kmanip_torch import env as kenv
from gym_kmanip_torch import teleop as tp

ENV_NAME: str = "KManipSoloArm"

# the headset loads the URDF from the web (the reference points at the
# kscalelabs/webstompy mirror)
URDF_WEB_BASE: str = "https://raw.githubusercontent.com/kscalelabs/webstompy/master/urdf"


def _upsert(session, schemas, item: dict) -> None:
    kwargs = {kk: v for kk, v in item.items() if kk != "schema"}
    session.upsert(schemas[item["schema"]](**kwargs), to="bgChildren")


def build_app(env, app, schemas, clock=time.time, log=print):
    """Wire the Vuer app: the HAND_MOVE handler and the env and scene
    session loop. `app` provides Vuer's decorators (add_handler, spawn),
    `schemas` the schema constructors by name. Returns the TeleopState."""
    bimanual = "eel_pos" in env.action_space.spaces
    teleop = tp.TeleopState(bimanual=bimanual)
    lock = asyncio.Lock()
    last_reset = [clock()]

    @app.add_handler("HAND_MOVE")
    async def hand_handler(event, _):
        async with lock:
            teleop.handle(event.value)

    async def run_env() -> None:
        async with lock:
            action = teleop.action()
            do_reset = teleop.consume_reset(clock(), last_reset[0])
        start = clock()
        env.step(action)
        log(f"env step took {(clock() - start) * 1000:.2f}ms")
        if do_reset:
            log("environment reset")
            env.reset()
            last_reset[0] = clock()

    @app.spawn(start=True)
    async def session_loop(session):
        src = f"{URDF_WEB_BASE}/{env.unwrapped.urdf_filename}"
        for item in tp.scene_static(env, src):
            _upsert(session, schemas, item)
        await asyncio.sleep(0.01)
        while True:
            await asyncio.gather(run_env(), asyncio.sleep(1 / tp.MAX_FPS))
            async with lock:
                for item in tp.scene_dynamic(env, teleop):
                    _upsert(session, schemas, item)

    return teleop


def main(env_name: str = ENV_NAME, device="cuda"):
    try:
        from vuer import Vuer
        from vuer.schemas import Box, Hands, Plane, PointLight, Sphere, Urdf
    except ImportError:
        raise SystemExit("vuer is not installed; `pip install vuer` on a machine with "
                         "network access to run VR teleop.")
    schemas = dict(Box=Box, Hands=Hands, Plane=Plane, PointLight=PointLight, Sphere=Sphere,
                   Urdf=Urdf)
    env = kenv.make(env_name, device=device)
    env.reset(seed=0)
    build_app(env, Vuer(), schemas)  # Vuer's spawn(start=True) blocks


if __name__ == "__main__":
    main()
