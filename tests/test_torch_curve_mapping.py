"""Port parity: the learnable monotone curve mapping against the JAX package
on the CPU (``utils/curve_mapping.py``).

The same log-gaps and inputs (numpy, from a seed) go through both packages
for each of the three control-point distributions; values and the
parameters' gradients of a weighted sum agree to rtol 1e-5 (atol 1e-6), and
the inputs get no gradient in either package. Inputs stay off the control
points (a point exactly on one is a kink)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.utils import curve_mapping as jcm
from geosplatting_tpu_torch.utils import curve_mapping as cm

from .torch_parity import n, one_torch_thread, t  # noqa: F401

K, C = 12, 3


def inputs(rng) -> np.ndarray:
    x = rng.uniform(0.0, 1.0, (5, 7, C)).astype(np.float32)
    x[0, 0] = 0.0          # both ends of the range
    x[0, 1] = 1.0
    return x


@pytest.mark.parametrize("dist", ["uniform", "log", "exp"])
def test_curve_values_and_gradients_match_jax(dist):
    rng = np.random.default_rng(3)
    gaps = (rng.standard_normal((K, C)) * 0.3).astype(np.float32)
    x = inputs(rng)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, xs):
        return jnp.sum(jcm.apply_curve(p, xs, point_distribution=dist) * w)

    out_j = jcm.apply_curve({"log_gaps": jnp.asarray(gaps)}, jnp.asarray(x),
                            point_distribution=dist)
    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))({"log_gaps": jnp.asarray(gaps)},
                                                 jnp.asarray(x))

    p = {"log_gaps": t(gaps).requires_grad_()}
    xt = t(x).requires_grad_()
    out_t = cm.apply_curve(p, xt, point_distribution=dist)
    gp_t, gx_t = torch.autograd.grad((out_t * t(w)).sum(), (p["log_gaps"], xt),
                                     allow_unused=True)
    np.testing.assert_allclose(n(out_t), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(gp_t), np.asarray(gp_j["log_gaps"]), rtol=1e-5, atol=1e-6)
    # the curve stops the inputs' gradient in both packages
    assert gx_t is None and not np.asarray(gx_j).any()
    # monotone in each channel, from 0 to 1
    xs = torch.linspace(0, 1, 101)[:, None].expand(101, C)
    ys = n(cm.apply_curve(p, xs, point_distribution=dist))
    assert (np.diff(ys, axis=0) >= 0).all()
    np.testing.assert_allclose(n(cm.curve_bins(p))[-1], 1.0, rtol=1e-6)
    np.testing.assert_allclose(n(cm.curve_bins(p)), np.asarray(jcm.curve_bins(
        {"log_gaps": jnp.asarray(gaps)})), rtol=1e-5)


def test_init_draws_from_the_generator():
    params = cm.init_curve(torch.Generator().manual_seed(0), K, C, device="cpu")
    again = cm.init_curve(torch.Generator().manual_seed(0), K, C, device="cpu")
    assert params["log_gaps"].shape == (K, C) and 0.05 < float(params["log_gaps"].std()) < 0.2
    torch.testing.assert_close(params["log_gaps"], again["log_gaps"], rtol=0, atol=0)
    x = torch.rand(4, C, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError):
        cm.apply_curve(params, x, point_distribution="cubic")
