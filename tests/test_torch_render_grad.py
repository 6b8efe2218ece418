"""Port parity: gradients of ``render``.

The port's tiled path (K1 -> sort -> K2 -> K3 forward; K4 -> K5 -> K6
backward, through their plain twins on the CPU) against JAX's autodiff of
its dense oracle render and against autograd through the port's own dense
oracle, on 200 Gaussians at 48x32 with a weighted loss on the image and the
inverse depth, SH degrees 0 and 1, within 3e-4 of each gradient's largest
magnitude (the JAX suite's tolerance, ``tests/test_rasterize.py``).  JAX's
own suite holds its Pallas render gradients to its dense oracle within the
same tolerance; the Pallas backward kernels are compared with the port's
twins one by one in ``test_torch_backward.py`` and ``test_torch_untile.py``.
The densification tap's gradient agrees within 5e-4.  Ties at a clamp bound
split the gradient as JAX does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops import sh as jsh
from gaussian_splatting_tpu.ops.rasterize import render as jax_render
from gaussian_splatting_tpu.utils.testing import random_scene as jax_random_scene
from gaussian_splatting_torch.ops import preprocess as tpre
from gaussian_splatting_torch.ops import sh as tsh
from gaussian_splatting_torch.ops.rasterize import _render, mark_visible, render
from gaussian_splatting_torch.utils.testing import random_scene

W, H, N = 48, 32, 200
NAMES = ("means3d", "scales", "quats", "opacities", "sh", "tap")


def _weights():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(3, H, W)).astype(np.float32),
            (0.1 * rng.normal(size=(H, W))).astype(np.float32))


def _port_grads(sh_degree, impl, kernels=True):
    s = random_scene(N, sh_degree=sh_degree, width=W, height=H, seed=2, device="cpu")
    leaves = [t.clone().requires_grad_(True) for t in
              (s.means3d, s.scales, s.quats, s.opacities, s.sh, torch.zeros(N, 2))]
    wimg, winvd = (torch.from_numpy(w) for w in _weights())
    out = _render(*leaves[:5], s.cam, s.bg, sh_degree=sh_degree, impl=impl,
                  means2d_tap=leaves[5], kernels=kernels)
    loss = (out.image * wimg).sum() + (out.invdepth * winvd).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)], out


@pytest.fixture(scope="module", params=[0, 1])
def grads(request):
    sh_degree = request.param
    s = jax_random_scene(N, sh_degree=sh_degree, width=W, height=H, seed=2)
    wimg, winvd = (jnp.asarray(w) for w in _weights())

    def loss(m, sc, q, o, sh, tap):
        out = jax_render(m, sc, q, o, sh, s.cam, s.bg, sh_degree=sh_degree, impl="dense",
                         means2d_tap=tap)
        return jnp.sum(out.image * wimg) + jnp.sum(out.invdepth * winvd)

    jgrads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        s.means3d, s.scales, s.quats, s.opacities, s.sh, jnp.zeros((N, 2)))
    tiled, out = _port_grads(sh_degree, "auto")
    dense, _ = _port_grads(sh_degree, "dense")
    return [np.asarray(g) for g in jgrads], tiled, dense, out


def _close(a, b, atol, name):
    scale = np.abs(b).max() + 1e-8
    np.testing.assert_allclose(a / scale, b / scale, atol=atol, err_msg=name)


def test_render_gradients_match_jax(grads):
    jgrads, tiled, _, out = grads
    assert not bool(out.overflow)
    for name, t, j in zip(NAMES[:5], tiled, jgrads):
        assert np.abs(j).max() > 0, name
        _close(t, j, 3e-4, name)


def test_render_gradients_match_port_dense_oracle(grads):
    _, tiled, dense, _ = grads
    for name, t, d in zip(NAMES, tiled, dense):
        _close(t, d, 3e-4, name)


def test_means2d_tap_gradient_matches_jax(grads):
    jgrads, tiled, _, _ = grads
    assert np.abs(jgrads[5]).sum() > 0
    np.testing.assert_allclose(tiled[5], jgrads[5], atol=5e-4, rtol=0)


def test_all_twin_path_gives_the_same_gradients():
    """``kernels=False`` is the card's reference; on the CPU both run the
    twins, so they agree to the bit."""
    a, _ = _port_grads(1, "auto")
    b, _ = _port_grads(1, "auto", kernels=False)
    for name, x, y in zip(NAMES, a, b):
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_inference_path_is_unchanged():
    """The inference render builds no graph and no gradient layout, and its
    values equal the differentiable forward to the bit."""
    s = random_scene(N, sh_degree=1, width=W, height=H, seed=2, device="cpu")
    args = (s.means3d, s.scales, s.quats, s.opacities, s.sh)
    leaves = [t.clone().requires_grad_(True) for t in args]
    inf = render(*leaves, s.cam, s.bg, sh_degree=1, inference=True)
    diff = render(*leaves, s.cam, s.bg, sh_degree=1)
    assert inf.image.grad_fn is None and diff.image.grad_fn is not None
    for name in ("image", "invdepth", "final_T", "radii", "num_instances", "overflow"):
        assert torch.equal(getattr(inf, name), getattr(diff, name)), name
    with torch.no_grad():
        plain = render(*args, s.cam, s.bg, sh_degree=1)
    assert torch.equal(plain.image, inf.image)


def test_mark_visible_matches_jax():
    from gaussian_splatting_tpu.ops.rasterize import mark_visible as jax_mark_visible

    s = random_scene(N, sh_degree=0, width=W, height=H, seed=4, spread=12.0, device="cpu")
    js = jax_random_scene(N, sh_degree=0, width=W, height=H, seed=4, spread=12.0)
    vis = mark_visible(s.means3d, s.cam.viewmatrix)
    assert 0 < int(vis.sum()) < N
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jax_mark_visible(
        js.means3d, js.cam.viewmatrix)))


def test_tie_gradients_match_jax():
    """At a clamp bound JAX's max/min/clip pass half the gradient; the port's
    bounds on gradient paths do the same (``torch.clamp`` would pass all)."""
    x = np.float32([0.2, 0.1, 0.3, -1.0, 1.0, 0.5])
    jg = jax.grad(lambda v: jnp.sum(jnp.clip(v, -1.0, 1.0) + jnp.maximum(v, 0.2)))(
        jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    (tpre.clip(t, -1.0, 1.0) + tpre.maximum(t, 0.2)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    assert float(t.grad[0]) == 1.5  # 1 through clip, 0.5 through the tie

    # SH colour exactly at its clamp at 0: DC coefficient with C0 * c == -0.5
    c = np.float32(-0.5 / tsh.SH_C0)
    while np.float32(tsh.SH_C0) * c != np.float32(-0.5):
        c = np.nextafter(c, np.float32(0.0), dtype=np.float32)
    sh = np.full((1, 1, 3), c, np.float32)
    means = np.float32([[0.0, 0.0, 1.0]])
    campos = np.float32([0.0, 0.0, -3.0])
    jg = jax.grad(lambda v: jnp.sum(jsh.sh_to_color(0, v, jnp.asarray(means),
                                                    jnp.asarray(campos))))(jnp.asarray(sh))
    ts = torch.from_numpy(sh).requires_grad_(True)
    tsh.sh_to_color(0, ts, torch.from_numpy(means), torch.from_numpy(campos)).sum().backward()
    np.testing.assert_array_equal(ts.grad.numpy(), np.asarray(jg))
    assert float(ts.grad[0, 0, 0]) == pytest.approx(0.5 * tsh.SH_C0)
