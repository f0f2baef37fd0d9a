"""The port's two fuzzers at their smallest, on the CPU: the gradient fuzzer
dilqr_tpu_torch/tools/fuzz_gradients.py at f64 (3 cases with --vmap 2: IFT
and KKT against the UNROLL oracle at its 1e-4, and vmap(grad) over 2 cost
scales against the loop of their gradients), and scripts/fuzz_torch_vs_jax.py
(2 cases with --grads: the port's solve and its IFT, KKT and UNROLL
gradients against the JAX package's at f64). Each must return 0, and 1 on a
mismatch."""
import importlib.util
import os

from dilqr_tpu_torch.tools import fuzz_gradients

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fuzz_gradients_passes_on_the_cpu(capsys):
    assert fuzz_gradients.main(["--device", "cpu", "--dtype", "float64", "--cases", "3",
                                "--vmap", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count(" ok ") == 3 and "vmap2 rel_err=" in out, out


def test_fuzz_gradients_exits_1_on_a_mismatch(capsys):
    """A bar no float64 case meets (0: IFT against the oracle differs by
    rounding) fails the case and the run."""
    assert fuzz_gradients.main(["--device", "cpu", "--dtype", "float64", "--cases", "1",
                                "--tol", "0"]) == 1
    assert "FAIL" in capsys.readouterr().out


def test_fuzz_torch_vs_jax_passes_with_grads(capsys):
    spec = importlib.util.spec_from_file_location(
        "fuzz_torch_vs_jax", os.path.join(REPO, "scripts", "fuzz_torch_vs_jax.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main(["--cases", "2", "--grads"]) == 0
    out = capsys.readouterr().out
    assert out.count("[PASS]") + out.count("[TIE ]") == 2 and " UNROLL " in out, out
