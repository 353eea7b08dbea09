"""The port's side-cars against the JAX package's modules on the same
inputs, on the CPU, with no JAX compile: the rerun logger (its JSON-lines
fallback and its SDK branch on a mock SDK), the checkpoint, the timers and
traces, the real-robot backend on a stubbed cv2, the live viewer's HTTP
surface, VR teleop (converters, gesture state machine, scene, the Vuer
wiring on a mock Vuer) and examples 0-5.

Where the JAX tests build a JAX env (tests/test_logging.py,
tests/test_viewer.py, tests/test_teleop.py), these build the port's env on
the CPU or a stub shell holding numpy arrays, so no JAX program compiles.
Frames are rendered with the top camera shrunk 8x (`small_top`): a full
480 x 640 frame takes ~1.6 s on one CPU thread.
"""

import asyncio
import contextlib
import dataclasses
import glob
import importlib
import json
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from gym_kmanip_tpu import constants as jk
from gym_kmanip_tpu import teleop as jtp
from gym_kmanip_tpu.dynamics.state import SimState as JaxSimState
from gym_kmanip_tpu.env import env_real as jenv_real
from gym_kmanip_tpu.log import log_rerun as jlog_rerun
from gym_kmanip_tpu.utils import checkpoint as jcheckpoint
from gym_kmanip_tpu.utils import profiling as jprofiling

from gym_kmanip_torch import constants as tk
from gym_kmanip_torch import env as kenv
from gym_kmanip_torch import teleop as tp
from gym_kmanip_torch.dynamics.state import SimState, init_state
from gym_kmanip_torch.env import env_real
from gym_kmanip_torch.log import log_rerun
from gym_kmanip_torch.models import get_model
from gym_kmanip_torch.mpc.mppi import MPPIConfig, init_mppi, sample_noise
from gym_kmanip_torch.utils import checkpoint, profiling
from gym_kmanip_torch.viewer import LiveViewer

torch.set_num_threads(1)
pytest.importorskip("gymnasium")


@contextlib.contextmanager
def small_top():
    """The top camera (env.render()'s) at 1/8 of its size."""
    top = tk.CAMERAS["top"]
    tk.CAMERAS["top"] = dataclasses.replace(top, w=top.w // 8, h=top.h // 8, fl=top.fl // 8,
                                            pp=(top.pp[0] // 8, top.pp[1] // 8))
    try:
        yield tk.CAMERAS["top"]
    finally:
        tk.CAMERAS["top"] = top


def _example(name):
    return importlib.import_module(f"gym_kmanip_torch.examples.{name}")


# -- the rerun logger -----------------------------------------------------------

def _logger_inputs(cams):
    rng = np.random.default_rng(0)
    info = dict(obs_list=("q_pos", "q_vel", "cube_pos", "cube_orn", "camera/grip_r"),
                act_list=("eer_pos", "grip_r"), cameras=cams, episode=2, q_keys=("a", "b"))
    steps = []
    for i in range(3):
        obs = {"q_pos": rng.normal(size=2).astype(np.float32),
               "q_vel": rng.normal(size=2).astype(np.float32),
               "cube_pos": rng.normal(size=3).astype(np.float32),
               "cube_orn": rng.normal(size=4).astype(np.float32),
               "camera/grip_r": np.zeros((40, 60, 3), np.uint8)}
        action = {"eer_pos": rng.normal(size=3).astype(np.float32),
                  "grip_r": rng.normal(size=1).astype(np.float32)}
        steps.append((action, obs, dict(info, sim_time=0.02 * i, cpu_time=100.0 + i, step=i)))
    return info, steps


def _write_episode(logger, cams, log_dir):
    info, steps = _logger_inputs(cams)
    logger.new(str(log_dir), info)
    for c in cams:
        logger.cam(c)
    for action, obs, step_info in steps:
        logger.step(action, obs, step_info)
    logger.end()
    return (log_dir / "episode_2.rrd.jsonl").read_text()


def test_rerun_fallback_matches_jax_line_for_line(tmp_path):
    """Without the rerun SDK both loggers write the same JSON lines, byte for
    byte, on the same inputs."""
    assert not jlog_rerun.HAS_RERUN
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _write_episode(jlog_rerun, [jk.CAMERAS["grip_r"]], tmp_path / "jax")
    got = _write_episode(log_rerun, [tk.CAMERAS["grip_r"]], tmp_path / "port")
    assert log_rerun.HAS_RERUN is False
    assert got == want
    kinds = [json.loads(line)["kind"] for line in got.splitlines()]
    assert kinds == ["blueprint", "pinhole", "step", "step", "step"]


def _mock_sdk(calls):
    def rec(name):
        def f(*a, **kw):
            calls.append((name, a, kw))
            return types.SimpleNamespace(name=name, a=a, kw=kw)

        return f

    rr = types.SimpleNamespace(**{n: rec(n) for n in (
        "init", "save", "disconnect", "log", "Pinhole", "Scalar", "Transform3D", "Image",
        "set_time_seconds", "set_time_sequence")})
    rrb = types.SimpleNamespace(**{n: rec(n) for n in (
        "TimeSeriesView", "Spatial2DView", "Spatial3DView", "Blueprint", "Horizontal",
        "Vertical")})
    return rr, rrb


def test_rerun_sdk_branch_matches_jax_on_a_mock_sdk(tmp_path, monkeypatch):
    """The SDK branch of both loggers against a call-recording mock of the
    rr / rrb surface (tests/test_logging.py:83-158): the same calls with the
    same arguments, but for the application id."""
    records = []
    for logger, cams in ((jlog_rerun, [jk.CAMERAS["grip_r"]]), (log_rerun, [tk.CAMERAS["grip_r"]])):
        calls = []
        rr, rrb = _mock_sdk(calls)
        monkeypatch.setattr(logger, "rr", rr)
        monkeypatch.setattr(logger, "rrb", rrb)
        monkeypatch.setattr(logger, "HAS_RERUN", True)
        info, steps = _logger_inputs(cams)
        logger.new(str(tmp_path), info)
        for c in cams:
            logger.cam(c)
        for action, obs, step_info in steps:
            logger.step(action, obs, step_info)
        logger.end()
        records.append(calls)
    want, got = records
    assert [c[0] for c in got] == [c[0] for c in want]
    names = [c[0] for c in got]
    assert names.count("Scalar") == 3 * (2 + 2 + 4) and names[-1] == "disconnect"
    for (name, a, kw), (_, ja, jkw) in zip(got, want):
        if name == "init":
            assert a == ("gym_kmanip_torch",) and ja == ("gym_kmanip_tpu",)
            continue
        assert len(a) == len(ja) and set(kw) == set(jkw), name
        for x, y in zip(list(a) + [kw[n] for n in sorted(kw)],
                        list(ja) + [jkw[n] for n in sorted(jkw)]):
            if isinstance(y, types.SimpleNamespace):
                assert x.name == y.name
            elif isinstance(y, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y, (name, x, y)


def test_env_log_rerun_episode(tmp_path, monkeypatch):
    """`KManipEnv(log_rerun=True)`: a log directory under DATA_DIR, one
    JSON-lines file an episode, a step line per step holding the step's
    host observation and action."""
    monkeypatch.setattr(tk, "DATA_DIR", str(tmp_path))
    env = kenv.make("KManipSoloArm", device="cpu", log_rerun=True, log_prefix="r")
    env.reset(seed=0)
    seen = []
    for _ in range(2):
        action = env.action_space.sample()
        obs, *_ = env.step(action)
        seen.append((action, obs))
    env.reset(seed=1)  # the first episode closes, the second opens
    env.close()
    files = sorted(glob.glob(str(tmp_path / "r.*" / "episode_*.rrd.jsonl")))
    assert [f.rsplit("_", 1)[-1] for f in files] == ["1.rrd.jsonl", "2.rrd.jsonl"]
    lines = [json.loads(line) for line in open(files[0])]
    assert [line["kind"] for line in lines] == ["blueprint", "step", "step"]
    assert lines[0]["obs_list"] == list(env.unwrapped.obs_list)
    for line, (action, obs) in zip(lines[1:], seen):
        assert line["q_pos"] == obs["q_pos"].tolist()
        assert line["action"]["eer_pos"] == action["eer_pos"].tolist()
    assert [json.loads(line)["kind"] for line in open(files[1])] == ["blueprint"]


# -- checkpoint -------------------------------------------------------------------

def test_checkpoint_round_trip_state_and_generator(tmp_path):
    """A SimState restores to its values, dtypes and device; an MPPIState's
    generator resumes its noise stream (tests/test_logging.py:66-80)."""
    m = get_model("solo_arm")
    s = init_state(m, device="cpu")._replace(qpos=torch.arange(10, dtype=torch.float32))
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, s)
    template = init_state(m, device="cpu")
    s2 = checkpoint.restore(path, template)
    assert type(s2) is SimState
    for a, b in zip(s, s2):
        assert torch.equal(a, b) and a.dtype == b.dtype and b.device == a.device

    cfg = MPPIConfig(horizon=3, n_samples=4)
    ms = init_mppi(m, cfg, seed=5, device="cpu")
    sigma = torch.ones(m.nu)
    sample_noise(ms.generator, 4, 3, m.nu, sigma, 0.9)
    checkpoint.save(path, ms)
    want = sample_noise(ms.generator, 4, 3, m.nu, sigma, 0.9)
    fresh = init_mppi(m, cfg, seed=0, device="cpu")
    ms2 = checkpoint.restore(path, fresh)
    assert ms2.generator is fresh.generator and torch.equal(ms2.nominal, ms.nominal)
    assert torch.equal(sample_noise(ms2.generator, 4, 3, m.nu, sigma, 0.9), want)


def test_checkpoint_files_cross_between_packages(tmp_path):
    """A file JAX's `checkpoint.save` writes restores in the port, and the
    other way round: the same leaf order (NamedTuple fields, dicts by
    sorted key, tuples and lists in order)."""
    rng = np.random.default_rng(0)
    fields = [rng.normal(size=n).astype(np.float32) for n in (10, 10, 10, 3, 4, 3, 3, 1)]
    jstate = JaxSimState(*fields)
    jtree = {"state": jstate, "b": [np.int32(7), (rng.normal(size=(2, 3)).astype(np.float32),)],
             "a": None}
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(path, jtree)
    m = get_model("solo_arm")
    template = {"state": init_state(m, device="cpu")._replace(time=torch.zeros(1)),
                "b": [torch.zeros((), dtype=torch.int32), (torch.zeros(2, 3),)], "a": None}
    got = checkpoint.restore(path, template)
    for want, have in zip(fields, got["state"]):
        np.testing.assert_array_equal(have.numpy(), want)
    assert got["b"][0].dtype == torch.int32 and int(got["b"][0]) == 7
    np.testing.assert_array_equal(got["b"][1][0].numpy(), jtree["b"][1][0])
    assert got["a"] is None and list(got) == ["state", "b", "a"]

    path = str(tmp_path / "port.npz")
    checkpoint.save(path, got)
    back = jcheckpoint.restore(path, jtree)
    for want, have in zip(fields, back["state"]):
        np.testing.assert_array_equal(np.asarray(have), want)
    assert int(back["b"][0]) == 7


# -- profiling --------------------------------------------------------------------

def test_timers_match_jax(monkeypatch):
    """Timer, Timers and TIMERS on one fake clock: the same totals, rates,
    reports and reprs as the JAX package's."""
    clock = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    out = []
    for mod in (jprofiling, profiling):
        timers = mod.Timers()
        for name in ("solve", "step", "solve"):
            with timers(name):
                pass
        t = timers("solve")
        out.append((t.total, t.count, t.mean_ms, t.rate_hz, repr(t), timers.report(),
                    mod.Timer("idle").rate_hz, type(mod.TIMERS).__name__))
    assert out[0] == out[1]
    assert out[1][1] == 2 and out[1][3] == 4.0


def test_sync_trace_and_timed_block(tmp_path):
    """`sync` returns the last leaf on the host (None for no leaf), `trace`
    writes a Chrome trace of the block, `timed_block_until_ready` calls
    warmup + n times and returns seconds per call."""
    tree = {"b": torch.arange(3), "a": (torch.ones(2),)}
    np.testing.assert_array_equal(profiling.sync(tree), np.arange(3))
    assert profiling.sync({}) is None
    with profiling.trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    calls = []
    seconds = profiling.timed_block_until_ready(lambda x: calls.append(x) or x + 1,
                                                torch.zeros(2), n=3, warmup=2)
    assert len(calls) == 5 and seconds >= 0.0


# -- the real-robot backend -------------------------------------------------------

class _FakeCapture:
    """cv2.VideoCapture returning one BGR frame of the asked size."""

    def __init__(self, device_id):
        self.props, self.released = {}, False

    def set(self, prop, value):
        self.props[prop] = value

    def read(self):
        h, w = int(self.props[4]), int(self.props[3])
        frame = np.zeros((h, w, 3), np.uint8)
        frame[..., 0] = 200  # blue in BGR
        return True, frame

    def release(self):
        self.released = True


_FAKE_CV2 = types.SimpleNamespace(VideoCapture=_FakeCapture, CAP_PROP_FRAME_WIDTH=3,
                                  CAP_PROP_FRAME_HEIGHT=4, CAP_PROP_FPS=5)


def _wait_for_frames(backend, timeout=5.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if all(r.frame.any() for r in backend.readers.values()):
            return
        time.sleep(0.01)
    raise AssertionError("no camera frame arrived")


def test_env_real_matches_jax_on_a_stubbed_cv2(monkeypatch):
    """`KManipEnv(sim=False)` on a stub cv2: the frames come back RGB, and
    the port's backend answers k_reset / k_step / k_render as the JAX
    package's does on the same stub; without cv2 both keep black frames."""
    monkeypatch.setitem(sys.modules, "cv2", _FAKE_CV2)
    env = kenv.make("KManipSoloArm", device="cpu", sim=False,
                    obs_list=["camera/grip_r", "camera/grip_l"])
    u = env.unwrapped
    assert type(u.env) is env_real.KManipEnvReal and u.info["sim"] is False
    _wait_for_frames(u.env)
    obs, info = env.reset(seed=0)
    assert sorted(obs) == ["camera/grip_l", "camera/grip_r"]
    assert obs["camera/grip_r"].shape == (40, 60, 3)
    assert (obs["camera/grip_r"][..., 2] == 200).all() and not obs["camera/grip_r"][..., 0].any()
    obs, reward, terminated, truncated, info = env.step(env.action_space.sample())
    assert reward == 0.0 and not terminated and info["step"] == 1

    monkeypatch.setattr(jenv_real, "cv2", _FAKE_CV2)
    monkeypatch.setattr(jenv_real, "HAS_CV2", True)
    shell = types.SimpleNamespace(cameras=[jk.CAMERAS["grip_r"]], q_len=10)
    jax_backend = jenv_real.new(shell)
    _wait_for_frames(jax_backend)
    want = jax_backend.k_step(None)
    got = u.env.k_step(None)
    assert want[:3] == got[:3]
    np.testing.assert_array_equal(got[3]["camera/grip_r"], want[3]["camera/grip_r"])
    np.testing.assert_array_equal(u.env.k_render(tk.CAMERAS["grip_r"]),
                                  jax_backend.k_render(jk.CAMERAS["grip_r"]))
    jax_backend.k_close()
    env.close()
    assert all(r._cap.released for r in u.env.readers.values())

    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    monkeypatch.setattr(jenv_real, "HAS_CV2", False)
    shell_t = types.SimpleNamespace(cameras=[tk.CAMERAS["grip_r"]], q_len=10)
    for backend in (env_real.new(shell_t), jenv_real.new(shell)):
        _, _, _, obs, _ = backend.k_reset()
        assert obs["camera/grip_r"].shape == (40, 60, 3) and not obs["camera/grip_r"].any()
        backend.k_close()


# -- the live viewer ---------------------------------------------------------------

@pytest.fixture(scope="module")
def viewer():
    with small_top():
        env = kenv.make("KManipSoloArm", device="cpu")
        v = LiveViewer(env, port=0)  # an ephemeral port
        url = v.start_server()
        env.reset(seed=0)
        v.step_once()  # publish the first frame
        yield v, url
        v.stop()
        env.close()


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=10) as r:
        return r.status, r.read(), r.headers.get("Content-Type")


def test_viewer_pages_and_state(viewer):
    """tests/test_viewer.py:37-57: the page, a PNG frame, the state JSON."""
    v, url = viewer
    status, body, ctype = _get(url, "/")
    assert status == 200 and ctype.startswith("text/html")
    assert b"live viewer" in body and b"/frame.png" in body
    status, body, ctype = _get(url, "/frame.png")
    assert status == 200 and ctype == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n"
    s = json.loads(_get(url, "/state")[1])
    assert s["step"] >= 1 and "reward" in s and "grip" in s
    with pytest.raises(urllib.error.HTTPError):
        _get(url, "/nothing")


def test_viewer_keys_pause_and_reset(viewer):
    """tests/test_viewer.py:60-91: a posted key is one impulse, space toggles
    the gripper, R resets, P pauses the stepping."""
    v, url = viewer
    req = urllib.request.Request(url + "/action", data=json.dumps({"key": "w"}).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.status == 200
    act, want_reset = v._compose_action()
    assert not want_reset and act["eer_pos"][1] == 1.0
    assert v._compose_action()[0]["eer_pos"][1] == 0.0
    g0 = v._grip
    v.handle_key(" ")
    assert v._grip == -g0
    v.handle_key("r")
    assert v._compose_action()[1]
    v.handle_key("p")
    step_before = v._state["step"]
    v.step_once()
    assert v._state["step"] == step_before
    v.handle_key("p")
    v.step_once()
    assert v._state["step"] == step_before + 1


def test_viewer_concurrent_requests(viewer):
    """tests/test_viewer.py:94-112: the threaded server under polling."""
    v, url = viewer
    errs = []

    def poll(path):
        try:
            for _ in range(5):
                assert _get(url, path)[0] == 200
        except Exception as e:  # noqa: BLE001 -- collected for the assert below
            errs.append(e)

    threads = [threading.Thread(target=poll, args=(p,)) for p in ("/frame.png", "/state", "/") * 2]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs and not any(t.is_alive() for t in threads)


def test_viewer_module_matches_jax():
    from gym_kmanip_tpu import viewer as jviewer
    from gym_kmanip_torch import viewer as tviewer

    assert tviewer._KEY_DELTAS == jviewer._KEY_DELTAS
    assert tviewer._PAGE.replace("torch", "tpu") == jviewer._PAGE


# -- teleop -----------------------------------------------------------------------

def _landmarks(thumb=(0, 0, 0), index=(1, 1, 1), middle=(1, 1, 1), pinky=(1, 1, 1)):
    lm = np.ones((25, 3)) * 5.0
    lm[tp.FINGER_THUMB] = thumb
    lm[tp.FINGER_INDEX] = index
    lm[tp.FINGER_MIDLE] = middle
    lm[tp.FINGER_PINKY] = pinky
    return lm.tolist()


def _wrist(euler_xyz=(0.0, 0.0, 0.0)):
    m = np.eye(4)
    m[:3, :3] = R.from_euler("xyz", euler_xyz).as_matrix()
    return m.reshape(-1).tolist()


def _hand_frames():
    """Pinch tracking on both hands, a left pinky re-anchor, a right reset."""
    frames = []
    for i in range(4):
        t = 0.002 * i
        frames.append({
            "rightLandmarks": _landmarks(thumb=(t, 0, 0), index=(t + 0.005, 0, 0),
                                         middle=(t + 0.05, 0, 0)),
            "rightHand": _wrist((0.0, 0.1 * i, 0.3)),
            "leftLandmarks": _landmarks(thumb=(0, 0.4, t), index=(0.005, 0.4, t),
                                        middle=(0, 0.4, 0.08)),
            "leftHand": _wrist((0.2, 0.0, -0.1 * i)),
        })
    frames.append({"rightLandmarks": _landmarks(), "rightHand": _wrist(),
                   "leftLandmarks": _landmarks(thumb=(0, 0.4, 0), pinky=(0, 0.405, 0)),
                   "leftHand": _wrist((0.1, 0.2, 0.3))})
    frames.append({"rightLandmarks": _landmarks(thumb=(0.3, 0.1, 0.2), pinky=(0.305, 0.1, 0.2)),
                   "rightHand": _wrist((0.1, 0.0, 0.0))})
    return frames


@pytest.mark.parametrize("bimanual", [False, True])
def test_teleop_state_machine_matches_jax(bimanual):
    """The same hand frames through both TeleopStates: equal hands, actions
    and resets after every frame (tests/test_teleop.py:33-116)."""
    states = [mod.TeleopState(bimanual=bimanual, hr_anchor=np.array([0.1, 0.2, 0.3]),
                              hl_anchor=np.array([0.0, 0.5, 0.0])) for mod in (jtp, tp)]
    for frame in _hand_frames():
        for ts in states:
            ts.handle(frame)
        want, got = states
        for side in ("right", "left"):
            for f in ("anchor_pos", "anchor_orn", "ee_pos", "ee_orn", "grip"):
                np.testing.assert_array_equal(getattr(getattr(got, side), f),
                                              getattr(getattr(want, side), f))
        assert got.reset_requested == want.reset_requested
        a, b = got.action(), want.action()
        assert list(a) == list(b) and all(np.array_equal(a[n], b[n]) for n in a)
    assert states[1].reset_requested
    for now, last in ((100.5, 100.0), (101.5, 100.0), (101.6, 101.5)):
        assert states[1].consume_reset(now, last) == states[0].consume_reset(now, last)


def test_frame_converters_match_jax_and_scipy():
    """constants.mj2vuer_* / vuer2mj_* and the wrist euler equal the JAX
    package's to the bit and scipy's Rotation formulation
    (tests/test_teleop.py:140-179), the quaternion's sign included."""
    mj2vuer_rot = R.from_euler("z", np.pi) * R.from_euler("x", np.pi / 2)
    vuer2mj_rot = mj2vuer_rot.inv()
    rng = np.random.default_rng(42)
    for _ in range(50):
        pos = rng.normal(size=3)
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)  # wxyz
        off = rng.normal(size=4)
        off /= np.linalg.norm(off)
        rot = R.from_quat(q[tk.XYZW_2_WXYZ])
        m4 = np.eye(4)
        m4[:3, :3] = rot.as_matrix()
        for got, want in ((tk.mj2vuer_pos(pos), jk.mj2vuer_pos(pos)),
                          (tk.vuer2mj_pos(pos), jk.vuer2mj_pos(pos)),
                          (tk.mj2vuer_orn(q), jk.mj2vuer_orn(q)),
                          (tk.mj2vuer_orn(q, off), jk.mj2vuer_orn(q, off)),
                          (tk.vuer2mj_orn(rot), jk.vuer2mj_orn(rot)),
                          (tk.vuer2mj_orn(rot.as_matrix()), jk.vuer2mj_orn(rot.as_matrix())),
                          (tp._wrist_euler(m4.ravel()), jtp._wrist_euler(m4.ravel()))):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(tk.mj2vuer_pos(pos), mj2vuer_rot.apply(pos), atol=1e-13)
        np.testing.assert_allclose(tk.mj2vuer_orn(q), (rot * mj2vuer_rot).as_euler("xyz"),
                                   atol=1e-12)
        np.testing.assert_allclose(tk.vuer2mj_orn(rot),
                                   (rot * vuer2mj_rot).as_quat()[tk.WXYZ_2_XYZW], atol=1e-13)
        np.testing.assert_allclose(tp._wrist_euler(m4.ravel()), rot.as_euler("xyz"), atol=1e-12)


def _shell(state, spaces):
    """A Gym env stand-in for the scene functions: `unwrapped.env.state`,
    the q fields and the action space."""
    q_keys = [f"j{i}" for i in range(10)]
    u = types.SimpleNamespace(env=types.SimpleNamespace(state=state), q_len=10, q_keys=q_keys,
                              q_dict={n: float(i) for i, n in enumerate(q_keys)},
                              urdf_filename="robot.urdf")
    return types.SimpleNamespace(unwrapped=u, action_space=types.SimpleNamespace(spaces=spaces))


@pytest.mark.parametrize("bimanual", [False, True])
def test_scene_descriptors_match_jax(bimanual):
    """scene_static and scene_dynamic on the same state: the port's from
    tensors in one copy, the JAX package's from numpy, equal descriptors."""
    rng = np.random.default_rng(3)
    fields = [rng.normal(size=n).astype(np.float32) for n in (10, 10, 10, 3, 4, 3, 3, 1)]
    spaces = {"eer_pos": None, **({"eel_pos": None} if bimanual else {})}
    jenv = _shell(JaxSimState(*fields), spaces)
    tenv = _shell(SimState(*(torch.as_tensor(f) for f in fields)), spaces)
    assert tp.scene_static(tenv, "u.urdf") == jtp.scene_static(jenv, "u.urdf")
    frames = _hand_frames()
    states = [mod.TeleopState(bimanual=bimanual) for mod in (jtp, tp)]
    for ts in states:
        ts.handle(frames[0])
    assert tp.scene_dynamic(tenv, states[1]) == jtp.scene_dynamic(jenv, states[0])


@pytest.fixture(scope="module")
def solo_env():
    env = kenv.make("KManipSoloArm", device="cpu")
    env.reset(seed=0)
    yield env
    env.close()


def test_scene_descriptors_on_the_port_env(solo_env):
    """tests/test_teleop.py:118-137 on the port's env."""
    items = tp.scene_static(solo_env, "https://example.test/robot.urdf")
    by_key = {i.get("key"): i for i in items if "key" in i}
    assert {"hands", "robot", "cube", "table", "hand_r"} <= set(by_key)
    assert "hand_l" not in by_key
    assert len(by_key["robot"]["jointValues"]) == solo_env.unwrapped.q_len
    assert np.all(np.isfinite(by_key["cube"]["position"]))
    dyn = tp.scene_dynamic(solo_env, tp.TeleopState(bimanual=False))
    assert [i["key"] for i in dyn] == ["robot", "cube", "hand_r"]
    assert set(dyn[0]["jointValues"]) == set(solo_env.unwrapped.q_keys)


def test_vuer_wiring_replay_with_mock_vuer(solo_env):
    """tests/test_teleop.py:182-312 on example 4's wiring and the port's
    env: a mock Vuer streams pinch frames while the session loop steps the
    env and upserts the scene; a thumb-pinky gesture then resets the
    episode once, through the lock and the backoff."""
    mod = _example("4_teleop")

    class StopSession(Exception):
        pass

    class MockSession:
        def __init__(self):
            self.upserts = []

        def upsert(self, obj, to=None):
            self.upserts.append((obj, to))

    schemas = {n: (lambda n: (lambda **kw: types.SimpleNamespace(schema=n, kwargs=kw)))(n)
               for n in ("Box", "Hands", "Plane", "PointLight", "Sphere", "Urdf")}
    frames = []
    for i in range(6):
        thumb = (0.002 * i, 0.0, 0.0)
        frames.append({"rightLandmarks": _landmarks(thumb=thumb, index=(thumb[0] + 0.005, 0, 0),
                                                    middle=(thumb[0] + 0.05, 0, 0)),
                       "rightHand": _wrist((0.0, 0.0, 0.1 * i))})
    frames.append({"rightLandmarks": _landmarks(thumb=(0.01, 0, 0), pinky=(0.012, 0, 0)),
                   "rightHand": _wrist()})
    t = [1000.0]

    def clock():
        t[0] += 0.5
        return t[0]

    resets = []
    real_reset = solo_env.reset

    def counting_reset(*a, **kw):
        resets.append(1)
        return real_reset(*a, **kw)

    class MockVuer:
        def __init__(self):
            self.handlers = {}
            self.session = MockSession()

        def add_handler(self, name):
            def deco(fn):
                self.handlers[name] = fn
                return fn

            return deco

        def spawn(self, start=True):
            def deco(fn):
                with pytest.raises(StopSession):
                    asyncio.run(self._run(fn))
                return fn

            return deco

        async def _run(self, session_fn):
            async def feed():
                for f in frames[:-1]:
                    await self.handlers["HAND_MOVE"](types.SimpleNamespace(value=f), None)
                    await asyncio.sleep(0)
                for _ in range(600):
                    if len(self.session.upserts) >= 9:
                        break
                    await asyncio.sleep(0.05)
                await self.handlers["HAND_MOVE"](types.SimpleNamespace(value=frames[-1]), None)
                for _ in range(600):
                    if resets:
                        break
                    await asyncio.sleep(0.05)
                raise StopSession

            await asyncio.gather(session_fn(self.session), feed())

    app = MockVuer()
    solo_env.reset = counting_reset
    try:
        teleop = mod.build_app(solo_env, app, schemas, clock=clock, log=lambda *a: None)
    finally:
        solo_env.reset = real_reset
    ups = app.session.upserts
    assert len(ups) >= 9
    assert [u[0].schema for u in ups[:6]] == ["PointLight", "Hands", "Urdf", "Box", "Plane",
                                              "Sphere"]
    assert all(u[1] == "bgChildren" for u in ups)
    assert {u[0].schema for u in ups[6:]} <= {"Urdf", "Box", "Sphere"}
    assert np.linalg.norm(teleop.right.ee_pos) > 0
    assert sum(resets) == 1


# -- examples 0-5 -----------------------------------------------------------------

def test_examples_0_and_3_write_frames(tmp_path):
    """Examples 0 (offline) and 3 at two steps: their frames as a GIF (no
    ffmpeg backend here), one per step, at the top camera's size."""
    imageio = pytest.importorskip("imageio")
    with small_top() as top:
        p0 = _example("0_viewer").main(num_steps=2, out_dir=str(tmp_path / "v"), device="cpu")
        p3 = _example("3_save_to_video").main(max_steps=2, video_path=str(tmp_path / "t.mp4"),
                                              device="cpu")
    for p in (p0, p3):
        frames = imageio.mimread(p)
        assert len(frames) == 2 and frames[0].shape[:2] == (top.h, top.w)


def test_example_1_control():
    rewards = _example("1_control").main(num_steps=3, device="cpu")
    assert len(rewards) == 3 and np.all(np.isfinite(rewards))


def test_examples_2_log_episodes(tmp_path, monkeypatch):
    """Examples 2 at two steps: the HDF5 file, the rerun fallback's lines
    and, from the synthetic-data heuristic, both."""
    pytest.importorskip("h5py")
    monkeypatch.setattr(tk, "DATA_DIR", str(tmp_path))
    d = _example("2_log_with_h5py").main(num_episodes=1, max_steps=2, device="cpu")
    assert len(glob.glob(f"{d}/episode_1.hdf5")) == 1
    d = _example("2_log_with_rerun").main(num_episodes=1, max_steps=2, device="cpu")
    kinds = [json.loads(line)["kind"] for line in open(f"{d}/episode_1.rrd.jsonl")]
    assert kinds == ["blueprint", "step", "step"]
    d, reward = _example("2_synthetic_data").main(num_episodes=1, max_steps=2, device="cpu")
    assert np.isfinite(reward)
    assert sorted(f.rsplit("/", 1)[-1] for f in glob.glob(f"{d}/episode_1.*")) == [
        "episode_1.hdf5", "episode_1.rrd.jsonl"]


def test_examples_4_and_5_guards(monkeypatch):
    """Example 4 raises without vuer, example 5 without lerobot (no upload
    is attempted)."""
    monkeypatch.setitem(sys.modules, "vuer", None)
    monkeypatch.setitem(sys.modules, "lerobot", None)
    with pytest.raises(SystemExit, match="vuer"):
        _example("4_teleop").main(device="cpu")
    with pytest.raises(SystemExit, match="lerobot"):
        _example("5_upload_dataset_to_hf").main()
