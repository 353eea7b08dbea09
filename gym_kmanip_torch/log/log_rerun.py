"""Visualization episode logger with the rerun new/cam/step/end protocol.

Port of `gym_kmanip_tpu/log/log_rerun.py`: the blueprint (3D scene,
per-camera 2D views, q and action time series), per-joint scalars per
step, the cube's transform, camera images and the four timelines
(sim_time, cpu_time, episode, step).

The rerun SDK is imported when the first episode opens. Where it is
absent, the same streams are written as one JSON line per record to
`episode_<n>.rrd.jsonl`, line for line as the JAX package's logger writes
them. As there, the logger is one per process: the four functions share
the open episode.

Arrays may be numpy arrays or tensors (copied to the host); the env hands
over its observations on the host already.
"""

import json
import os
from typing import Any, Dict, List

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.log.log_h5py import _np

rr = None
rrb = None
HAS_RERUN = None  # unknown until the first episode opens
_state: Dict[str, Any] = {"f": None, "path": None}


def _load_sdk() -> bool:
    """Import the rerun SDK once; True where it is installed."""
    global rr, rrb, HAS_RERUN
    if HAS_RERUN is None:
        try:
            import rerun
            import rerun.blueprint
        except ImportError:
            HAS_RERUN = False
        else:
            rr, rrb, HAS_RERUN = rerun, rerun.blueprint, True
    return HAS_RERUN


def new(log_dir: str, info: Dict[str, Any]) -> None:
    assert os.path.exists(log_dir), f"Directory {log_dir} does not exist"
    if _load_sdk():
        views: List[Any] = []
        if "q_pos" in info["obs_list"]:
            views.append(rrb.TimeSeriesView(origin="/state/q_pos", name="q_pos"))
        if "q_vel" in info["obs_list"]:
            views.append(rrb.TimeSeriesView(origin="/state/q_vel", name="q_vel"))
        if len(info["act_list"]) > 0:
            views.append(rrb.TimeSeriesView(origin="/action", name="action"))
        cam_views = [rrb.Spatial2DView(origin=c.log_name, name=c.name) for c in info["cameras"]]
        blueprint = rrb.Blueprint(rrb.Horizontal(
            rrb.Vertical(rrb.Spatial3DView(origin="/world", name="scene"),
                         rrb.Horizontal(*cam_views)),
            rrb.Vertical(*views)))
        rr.init("gym_kmanip_torch", default_blueprint=blueprint)
        rr.save(os.path.join(log_dir, f"episode_{info['episode']}.rrd"))
    else:
        path = os.path.join(log_dir, f"episode_{info['episode']}.rrd.jsonl")
        _state["f"] = open(path, "w")
        _state["path"] = path
        _state["f"].write(json.dumps({
            "kind": "blueprint",
            "obs_list": list(info["obs_list"]),
            "act_list": list(info["act_list"]),
            "cameras": [c.name for c in info["cameras"]],
        }) + "\n")


def end() -> None:
    if HAS_RERUN:
        rr.disconnect()
    elif _state["f"] is not None:
        _state["f"].close()
        _state["f"] = None


def cam(cam_: k.Cam) -> None:
    if HAS_RERUN:
        rr.log(f"world/camera/{cam_.name}",
               rr.Pinhole(resolution=[cam_.w, cam_.h], focal_length=cam_.fl,
                          principal_point=cam_.pp))
    elif _state["f"] is not None:
        _state["f"].write(json.dumps({
            "kind": "pinhole",
            "camera": cam_.name,
            "resolution": [cam_.w, cam_.h],
            "focal_length": cam_.fl,
            "principal_point": list(cam_.pp),
        }) + "\n")


def step(action: Dict[str, Any], observation: Dict[str, Any], info: Dict[str, Any]) -> None:
    if HAS_RERUN:
        rr.set_time_seconds("sim_time", info["sim_time"])
        rr.set_time_seconds("cpu_time", info["cpu_time"])
        rr.set_time_sequence("episode", info["episode"])
        rr.set_time_sequence("step", info["step"])
        q_pos = _np(observation["q_pos"]) if "q_pos" in observation else None
        q_vel = _np(observation["q_vel"]) if "q_vel" in observation else None
        for i, key in enumerate(info["q_keys"]):
            if q_pos is not None:
                rr.log(f"state/q_pos/{key}", rr.Scalar(float(q_pos[i])))
            if q_vel is not None:
                rr.log(f"state/q_vel/{key}", rr.Scalar(float(q_vel[i])))
        for name, val in action.items():
            for j, v in enumerate(_np(val).reshape(-1)):
                rr.log(f"action/{name}/{j}", rr.Scalar(float(v)))
        if "cube_pos" in observation:
            rr.log("world/cube", rr.Transform3D(translation=_np(observation["cube_pos"])))
        for c in info["cameras"]:
            rr.log(c.log_name, rr.Image(_np(observation[c.log_name])))
    elif _state["f"] is not None:
        rec = {
            "kind": "step",
            "sim_time": info["sim_time"],
            "cpu_time": info["cpu_time"],
            "episode": info["episode"],
            "step": info["step"],
            "action": {n: _np(v).reshape(-1).tolist() for n, v in action.items()},
            "q_pos": _np(observation.get("q_pos", [])).tolist(),
            "q_vel": _np(observation.get("q_vel", [])).tolist(),
            "cube_pos": _np(observation.get("cube_pos", [])).tolist(),
            "cube_orn": _np(observation.get("cube_orn", [])).tolist(),
            "images": {c.name: [int(x) for x in _np(observation[c.log_name]).shape]
                       for c in info["cameras"]},
        }
        _state["f"].write(json.dumps(rec) + "\n")
        _state["f"].flush()
