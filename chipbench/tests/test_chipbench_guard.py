"""The import guard compares whole top-level names."""
import subprocess
import sys

from chipbench import guard, harness


def test_top_level_names_are_compared_whole():
    names = ["repro_torch", "repro_torch.models.zoo", "reprox", "jaxtyping",
             "repro", "repro.core", "jax", "jax.numpy", "jaxlib.xla_client",
             "flax.linen", "numpy"]
    assert guard.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "repro",
        "repro.core"]


def test_the_port_and_the_harness_load_no_forbidden_module():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "import repro_torch.serve.engine, repro_torch.train.step\n"
            "from chipbench import harness, guard, trace, traffic\n"
            "from chipbench.drivers import serve\n"
            "from chipbench.reference import rwkv6, zamba2\n"
            "for m in harness.benchmark()['per_layer']:\n"
            "    harness.metric_module(m['name'])\n"
            "guard.check('test')\n")
    proc = subprocess.run([sys.executable, "-c", code, str(harness.ROOT),
                           str(harness.SRC)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert "no jax" in proc.stderr


def test_the_guard_exits_when_the_jax_package_is_loaded():
    code = ("import sys, types; sys.path[:0] = [sys.argv[1]]\n"
            "sys.modules['repro'] = types.ModuleType('repro')\n"
            "from chipbench import guard\n"
            "guard.check('test')\n")
    proc = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)],
                          capture_output=True, text=True)
    assert proc.returncode == 3 and "repro" in proc.stderr
