"""The port's trainable set-abstraction pool (``sa_mlp_pool_trainable``)
against the JAX package's (``tests/test_sa_vjp.py``'s cases): the forward
against the plain version, the gradient against the JAX package's custom
VJP and its jnp twin, bf16 against float32.

Tolerances: float32 forwards and gradients within rtol 1e-5 / atol 1e-5
(the same math, sums in another order); ties split the gradient evenly in
both frameworks, so rows whose neighbours tie are held to the same
tolerance. bfloat16 forwards stay within 3% of the float32 forward (the
JAX package's bound), the bfloat16 gradients within rtol/atol 2e-2 of the
JAX package's bfloat16 gradients (an operand or cotangent that lands an
ulp apart rounds to another bfloat16 value, 2^-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu.ops.pallas import kernels as pk
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
    pointnet as tpn)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _case(m=64, k=16, cin=3, dims=(8, 8, 16), seed=0):
    """``tests/test_sa_vjp.py``'s random case (rows 0-1 with no valid
    neighbour), plus row 2 whose neighbours all repeat one valid row (the
    padding's exact ties) and row 3 all zeros under zero first-layer
    biases, whose ReLUs tie at 0."""
    rng = np.random.RandomState(seed)
    grouped = rng.randn(m, k, cin).astype(np.float32)
    valid = rng.rand(m, k) > 0.3
    valid[:2] = False
    grouped[2] = grouped[2, :1]
    valid[2] = True
    grouped[3] = 0.0
    valid[3] = True
    ws, a = [], cin
    for li, b in enumerate(dims):
        bias = (rng.randn(b) * 0.1).astype(np.float32)
        if li == 0:
            bias[:] = 0.0
        ws.append(((rng.randn(a, b) * 0.5).astype(np.float32), bias))
        a = b
    return grouped, valid, ws


def _t(x, grad=False):
    return torch.tensor(np.array(x), requires_grad=grad)


def _torch_grads(grouped, valid, ws, dtype=torch.float32):
    args = [_t(grouped, True)] + [_t(x, True) for w in ws for x in w]
    out = tpn.sa_mlp_pool_trainable(args[0], _t(valid),
                                    list(zip(args[1::2], args[2::2])),
                                    compute_dtype=dtype)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [a.grad.numpy() for a in args]


def _jax_grads(grouped, valid, ws, fused=True, dtype=jnp.float32):
    def loss(g, *flat):
        pairs = list(zip(flat[::2], flat[1::2]))
        if fused:
            out = pk.sa_mlp_pool_trainable(g, jnp.asarray(valid), pairs,
                                           compute_dtype=dtype)
        else:
            out = pk._sa_jnp_math(dtype, g, jnp.asarray(valid), *flat)
        return jnp.sum(out ** 2)

    args = [jnp.asarray(grouped)] + [jnp.asarray(x) for w in ws for x in w]
    return [np.asarray(g) for g in
            jax.grad(loss, argnums=tuple(range(7)))(*args)]


def test_forward_matches_reference_f32():
    grouped, valid, ws = _case()
    out, _ = _torch_grads(grouped, valid, ws)
    tw = [(_t(w), _t(b)) for w, b in ws]
    ref = tpn.sa_mlp_pool_reference(_t(grouped), _t(valid), tw)
    np.testing.assert_array_equal(out, ref.numpy())  # the CPU forward
    jref = pk.sa_mlp_pool_reference(
        jnp.asarray(grouped), jnp.asarray(valid),
        [(jnp.asarray(w), jnp.asarray(b)) for w, b in ws])
    np.testing.assert_allclose(out, np.asarray(jref), **TOL)
    jmath = pk._sa_jnp_math(jnp.float32, jnp.asarray(grouped),
                            jnp.asarray(valid),
                            *(jnp.asarray(x) for w in ws for x in w))
    np.testing.assert_allclose(out, np.asarray(jmath), **TOL)
    assert not out[:2].any()


@pytest.mark.parametrize("fused", [True, False], ids=["custom_vjp", "jnp"])
def test_grad_matches_jax(fused):
    grouped, valid, ws = _case()
    _, got = _torch_grads(grouped, valid, ws)
    want = _jax_grads(grouped, valid, ws, fused=fused)
    names = ["grouped", "W1", "b1", "W2", "b2", "W3", "b3"]
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    # rows with no valid neighbour get no gradient; the tied rows do
    assert np.abs(got[0][:2]).max() == 0.0
    assert np.abs(got[0][2]).max() > 0.0


def test_tied_rows_split_the_gradient_evenly():
    """All 16 neighbours of row 2 are one point: each gets 1/16 of the
    row's gradient (``amax``; ``max(dim)`` would give it all to one)."""
    grouped, valid, ws = _case()
    _, got = _torch_grads(grouped, valid, ws)
    dg = got[0][2]
    np.testing.assert_allclose(dg, np.broadcast_to(dg[:1], dg.shape),
                               rtol=1e-6, atol=0)


def test_valid_gets_no_gradient_and_grad_is_finite():
    grouped, valid, ws = _case(m=32, k=8)
    g = _t(grouped, True)
    v = _t(valid)
    tw = [(_t(w, True), _t(b, True)) for w, b in ws]
    tpn.sa_mlp_pool_trainable(g, v, tw).sum().backward()
    assert v.grad is None and torch.isfinite(g.grad).all()
    assert all(torch.isfinite(t.grad).all() for pair in tw for t in pair)


def test_bf16_parity():
    grouped, valid, ws = _case(m=128, k=16, seed=3)
    out16, g16 = _torch_grads(grouped, valid, ws, torch.bfloat16)
    out32, g32 = _torch_grads(grouped, valid, ws, torch.float32)
    scale = max(1.0, np.abs(out32).max())
    assert np.abs(out16 - out32).max() / scale < 0.03
    assert np.abs(out16 - out32).max() > 1e-4  # the operands are rounded
    want = _jax_grads(grouped, valid, ws, dtype=jnp.bfloat16)
    for a, b in zip(g16, want):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, **BF16_TOL)
    cos = float((g16[0] * g32[0]).sum()
                / (np.linalg.norm(g16[0]) * np.linalg.norm(g32[0])))
    assert cos > 0.97


def test_refuses_other_than_three_layers():
    grouped, valid, ws = _case()
    with pytest.raises(ValueError, match="3 MLP layers"):
        tpn.sa_mlp_pool_trainable(_t(grouped), _t(valid),
                                  [(_t(w), _t(b)) for w, b in ws[:2]])
