"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference loads nothing of the port."""

import os
import subprocess
import sys

from harness import guard

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def test_top_level_names_are_compared_whole():
    assert guard.jax_modules(["gym_kmanip_torch", "gym_kmanip_torch.mpc.mppi", "jaxtyping",
                              "flaxen", "gym_kmanip_t"]) == []
    assert guard.jax_modules(["jax.numpy"]) == ["jax"]
    assert guard.jax_modules(["jaxlib.xla_client", "flax.linen", "gym_kmanip_tpu.mpc"]) == [
        "flax", "gym_kmanip_tpu", "jaxlib"]


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n{code}\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_reference_imports_nothing_of_the_port():
    names = _modules_after("from reference import model, dynamics, mppi, scene\n"
                           "model.load('torso')")
    assert "gym_kmanip_torch" not in names
    assert not names & guard.FORBIDDEN


def test_a_run_loads_no_jax():
    code = ("from conftest import tiny_cell\n"
            "from harness import runner\n"
            "runner.run_cell(tiny_cell(), 3, 0.2, False, 'cpu')\n")
    names = _modules_after(f"sys.path.insert(0, {os.path.join(BENCH, 'tests')!r})\n{code}")
    assert "gym_kmanip_torch" in names
    assert not names & guard.FORBIDDEN
