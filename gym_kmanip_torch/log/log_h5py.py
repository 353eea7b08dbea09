"""HDF5 episode logger (ACT / LeRobot layout).

Port of `gym_kmanip_tpu/log/log_h5py.py`, with the same file schema and
the same new/cam/step/end protocol: `observations/qpos|qvel` and `action`
of MAX_EPISODE_STEPS rows, `observations/images/<cam>` uint8 datasets
chunked one frame per chunk, the episode's info under the `metadata`
group's attrs, a `metadata/<cam log name>` group per camera, a flush per
step. The action dataset holds the whole flattened action in act_list
order, sized by the true action dimension (`info["act_dims"]`).

Arrays may be numpy arrays or tensors on any device. h5py is imported when
a file is opened, so importing this module needs none.
"""

import os
from typing import Any, Dict

import numpy as np

from gym_kmanip_torch import constants as k


def _np(x) -> np.ndarray:
    """numpy view of an array or a tensor (copied to the host)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _action_dim(info: Dict[str, Any]) -> int:
    act_dims = info.get("act_dims")
    if act_dims:
        return max(sum(act_dims.values()), 1)
    dims = {"eel_pos": 3, "eel_orn": 3, "eer_pos": 3, "eer_orn": 3,
            "grip_l": 1, "grip_r": 1, "q_pos_r": 7, "q_pos_l": 7}
    return max(sum(dims.get(name, 0) for name in info["act_list"]), 1)


def new(log_dir: str, info: Dict[str, Any]):
    """Open `episode_<info["episode"]>.hdf5` under `log_dir` (which must
    exist) with the episode's metadata and empty qpos, qvel and action
    datasets; returns the h5py.File."""
    import h5py

    if not os.path.exists(log_dir):
        raise FileNotFoundError(f"Directory {log_dir} does not exist")
    log_path = os.path.join(log_dir, f"episode_{info['episode']}.hdf5")
    f = h5py.File(log_path, "w", rdcc_nbytes=k.H5PY_CHUNK_SIZE_BYTES)
    f.attrs["sim"] = info["sim"]
    g = f.create_group("metadata")
    for key, value in info.items():
        try:
            g.attrs[key] = value
        except TypeError:
            pass  # entries HDF5 cannot store (Cam specs, dicts)
    f.create_group("observations/images")
    f.create_dataset("observations/qpos", (k.MAX_EPISODE_STEPS, info["q_len"]))
    f.create_dataset("observations/qvel", (k.MAX_EPISODE_STEPS, info["q_len"]))
    f.create_dataset("action", (k.MAX_EPISODE_STEPS, _action_dim(info)))
    return f


def end(f) -> None:
    if f is not None:
        f.close()


def cam(f, cam: k.Cam) -> None:
    """The camera's metadata group and its frame dataset."""
    g = f.create_group(f"metadata/{cam.log_name}")
    g.attrs["resolution"] = [cam.w, cam.h]
    g.attrs["focal_length"] = cam.fl
    g.attrs["principal_point"] = cam.pp
    f.create_dataset(
        f"/observations/images/{cam.name}",
        (k.MAX_EPISODE_STEPS, cam.h, cam.w, cam.c),
        dtype=cam.dtype,
        chunks=(1, cam.h, cam.w, cam.c),
    )


def step(f, action: Dict[str, Any], observation: Dict[str, Any], info: Dict[str, Any]) -> None:
    """Row info["step"] - 1: the flattened action, qpos, qvel and each
    camera's frame (a recording without cameras has no image datasets)."""
    idx: int = info["step"] - 1
    flat = np.concatenate(
        [_np(action[name]).reshape(-1) for name in info["act_list"] if name in action]
    ) if action else np.zeros(1)
    n = min(len(flat), f["action"].shape[1])
    f["action"][idx, :n] = flat[:n]
    if "q_pos" in observation:
        f["observations/qpos"][idx] = _np(observation["q_pos"])
    if "q_vel" in observation:
        f["observations/qvel"][idx] = _np(observation["q_vel"])
    for cam_ in info.get("cameras", ()):
        f[f"/observations/images/{cam_.name}"][idx] = _np(observation[cam_.log_name])
    f.flush()
