"""seamless-m4t-large-v2's gradient at full depth (24 encoder and 24
decoder layers, and 12 + 12) at the smoke config's widths: the port's
float32 gradient against the JAX reference's on the same weights and
batch, each held against a float64 copy of the port
(``tests/encdec_grad_norm.py``). A depth-amplified fault in the port's
encoder or cross-attention backward would move the port away from both.
At full width the random-init encoder's gradient (float64: 16 at one
layer, 4.7e3 at two, 1.9e6 at four) keeps no digit in any float32 code,
the reference's included (PERF.md), so the depth is held here, at narrow
widths, where both float32 codes keep digits."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from encdec_grad_norm import cpu_run, float64_port, overrides  # noqa: E402

TOL = 1e-5          # the loss: float32 against float64
REGIME = 1e-3       # float32 keeps digits of the gradient (relative L2)


@pytest.fixture(scope="module")
def f64(tmp_path_factory):
    return float64_port(str(tmp_path_factory.mktemp("f64")))


@pytest.mark.parametrize("layers", [12, 24])
def test_port_gradient_matches_jax_at_full_depth(f64, layers):
    """The loss of both float32 codes within TOL of float64's; the whole
    gradient (every leaf, relative L2) no further from float64's than
    twice the reference's, which keeps digits at these widths (12 + 12:
    both 1.7e-4 to 1.8e-4 away; 24 + 24: both 1.8e-6 to 1.9e-6)."""
    r = cpu_run(overrides(layers, d_model=64, d_ff=128, heads=4), seq=32,
                seed=0, f64=f64)
    jax, port, exact = r["jax_f32"], r["port_f32"], r["port_f64"]
    for side in (jax, port):
        assert side["loss"] == pytest.approx(exact["loss"], rel=TOL)
    assert jax["rel_l2_to_f64"] <= REGIME
    assert port["rel_l2_to_f64"] <= 2 * jax["rel_l2_to_f64"] + 1e-6
